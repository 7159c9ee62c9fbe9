"""Measure multi-host chains/s weak-scaling efficiency on CPU.

The north-star asks >=80% chains/s efficiency from 1 host to N>=2 hosts
(BASELINE.md).  This script measures the `jax.distributed` code path with
N core-pinned CPU processes (1 XLA device each, localhost grpc between
them) and 2 chains per process — the dispatch and coordination overhead,
not a device rate:

    efficiency = chains_steps_per_sec(N procs) /
                 (N * chains_steps_per_sec(1 proc))

Each worker times the steady-state segments only (first two segments —
compile + warmup — are dropped).  Prints one JSON line; the number is
recorded in BASELINE.md.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "scripts", "mh_scale_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_fleet(nprocs: int) -> float:
    out_json = tempfile.mktemp(suffix=".json")
    port = _free_port()
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ, PYTHONPATH=_REPO,
                   MH_AFFINITY=str(pid % os.cpu_count()))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, str(pid), str(nprocs), str(port),
             out_json],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = [p.communicate()[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{out}")
    with open(out_json) as fh:
        return json.load(fh)["chain_steps_per_sec"]


def main():
    t1 = run_fleet(1)
    t2 = run_fleet(2)
    eff = t2 / (2.0 * t1)
    print(json.dumps({
        "metric": "multihost_chain_steps_weak_scaling_efficiency_1to2",
        "value": round(eff, 4),
        "unit": "fraction",
        "vs_baseline": -1.0,
        "detail": {"chain_steps_per_sec_1proc": round(t1, 2),
                   "chain_steps_per_sec_2proc_total": round(t2, 2),
                   "panel": [200, 2000, 2], "chains_per_proc": 2},
    }))


if __name__ == "__main__":
    main()
