"""Worker for scripts/measure_multihost_scaling.py: one core-pinned
process of an N-process `jax.distributed` CPU fleet, measuring
steady-state chains/s of run_mcmc over a process-spanning chain mesh.

Usage: mh_scale_worker.py <pid> <nprocs> <port> <out_json>
Env: MH_AFFINITY=<core> pins the process; one XLA CPU device per process
(weak scaling: 2 chains per process, work per step sized to swamp
dispatch and the localhost grpc collectives).
"""

import json
import os
import sys
import time

if "MH_AFFINITY" in os.environ:
    os.sched_setaffinity(0, {int(os.environ["MH_AFFINITY"])})
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)


def main():
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    out_path = sys.argv[4]

    from instruct_jax.parallel.distributed import (global_chain_mesh,
                                                   initialize_multihost)
    if nprocs > 1:
        initialize_multihost(coordinator_address=f"localhost:{port}",
                             num_processes=nprocs, process_id=pid)

    import numpy as np

    from instruct_jax.config import ModelSpec, Schedule
    from instruct_jax.data.synthetic import synthetic_panel
    from instruct_jax.mcmc.driver import run_mcmc

    panel = synthetic_panel(n_indv=200, n_loci=2000, n_pops=2, seed=11)
    spec = ModelSpec(mode=2, n_pops=2, use_pallas=False)
    seg = 25
    n_chains = 2 * nprocs
    sched = Schedule(n_iter=8 * seg, burnin=seg, thinning=2,
                     n_chains=n_chains, ckrep=10,
                     nstep_check_empty_cluster=10)
    mesh = global_chain_mesh() if nprocs > 1 else None

    stamps = []

    def progress(start, states, accums):
        stamps.append((start, time.time()))

    res = run_mcmc(panel.data, spec, sched, jax.random.key(5), mesh=mesh,
                   progress_every=seg, progress_fn=progress)
    assert np.isfinite(np.asarray(res.accum.mean.total_ll)).all()

    if pid == 0:
        # steady state: drop the first two segments (compile + warmup)
        (s0, t0), (s1, t1) = stamps[2], stamps[-1]
        chain_steps_per_sec = (s1 - s0) * n_chains / (t1 - t0)
        with open(out_path, "w") as fh:
            json.dump({"nprocs": nprocs, "n_chains": n_chains,
                       "chain_steps_per_sec": chain_steps_per_sec}, fh)
    if nprocs > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    main()
