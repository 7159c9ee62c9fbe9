"""2-process `jax.distributed` CPU test of the multi-host path
(parallel/distributed.py; survey §4 test plan item 3).

Launches two subprocesses that initialize a distributed runtime, build the
same global ("chain", "data") mesh over 4 devices (2 per process) and run
run_mcmc with chains sharded across processes.  The posterior summaries
must match a single-process run of the same configuration: the chain
shard_map partitions the vmapped per-chain programs without changing any
per-chain PRNG stream, so agreement is near-bitwise.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(600)
def test_two_process_chain_parallel(tmp_path):
    port = _free_port()
    out_json = str(tmp_path / "mh.json")
    worker = os.path.join(_REPO, "tests", "_mh_worker.py")
    env = dict(os.environ, PYTHONPATH=_REPO)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(port), out_json],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    with open(out_json) as fh:
        mh = json.load(fh)

    # single-process baseline: identical config, no mesh (pure vmap) —
    # per-chain keys and math are the same, so posteriors agree
    import jax
    from instruct_jax.config import ModelSpec, Schedule
    from instruct_jax.data.synthetic import synthetic_panel
    from instruct_jax.mcmc.driver import run_mcmc

    panel = synthetic_panel(n_indv=30, n_loci=24, n_pops=2, seed=11)
    spec = ModelSpec(mode=2, n_pops=2, use_pallas=False)
    sched = Schedule(n_iter=300, burnin=100, thinning=2, n_chains=4,
                     ckrep=20, nstep_check_empty_cluster=20)
    res = run_mcmc(panel.data, spec, sched, jax.random.key(5))

    np.testing.assert_allclose(np.asarray(mh["rates"]),
                               np.asarray(res.accum.mean.rates),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(mh["q"]),
                               np.asarray(res.accum.mean.q), atol=1e-4)
    np.testing.assert_allclose(np.asarray(mh["total_ll"]),
                               np.asarray(res.accum.mean.total_ll),
                               rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(mh["ll_marg"]),
        np.asarray(res.accum.mean.ll_marg).sum(-1), rtol=1e-5)
