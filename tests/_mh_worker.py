"""Worker for tests/test_multihost.py: one process of a 2-process
`jax.distributed` CPU fleet running run_mcmc over a process-spanning
chain-parallel mesh (the multi-host recipe of parallel/distributed.py).

Usage: python _mh_worker.py <process_id> <coordinator_port> <out_json>
Every process computes the full (allgathered) posterior summary; process 0
writes it as JSON.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)


def main():
    pid = int(sys.argv[1])
    port = int(sys.argv[2])
    out_path = sys.argv[3]

    from instruct_jax.parallel.distributed import (global_chain_mesh,
                                                   initialize_multihost)
    initialize_multihost(coordinator_address=f"localhost:{port}",
                         num_processes=2, process_id=pid)
    assert jax.process_count() == 2
    assert len(jax.devices()) == 4          # 2 local per process

    import numpy as np

    from instruct_jax.config import ModelSpec, Schedule
    from instruct_jax.data.synthetic import synthetic_panel
    from instruct_jax.mcmc.driver import run_mcmc

    panel = synthetic_panel(n_indv=30, n_loci=24, n_pops=2, seed=11)
    spec = ModelSpec(mode=2, n_pops=2, use_pallas=False)
    sched = Schedule(n_iter=300, burnin=100, thinning=2, n_chains=4,
                     ckrep=20, nstep_check_empty_cluster=20)
    mesh = global_chain_mesh()              # 4 global devices, chains-major
    res = run_mcmc(panel.data, spec, sched, jax.random.key(5), mesh=mesh)

    if pid == 0:
        out = {
            "rates": np.asarray(res.accum.mean.rates).tolist(),
            "q": np.asarray(res.accum.mean.q).tolist(),
            "total_ll": np.asarray(res.accum.mean.total_ll).tolist(),
            "ll_marg": np.asarray(res.accum.mean.ll_marg)
                         .sum(-1).tolist(),
        }
        with open(out_path, "w") as fh:
            json.dump(out, fh)
    # all processes must stay alive until the collectives finish
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    main()
