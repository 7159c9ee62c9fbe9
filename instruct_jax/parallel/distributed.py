"""Multi-host entry points.

The reference is a single process (survey §2.2).  Here multi-host scaling
is the standard JAX recipe: every host calls
:func:`initialize_multihost`, builds the same global ("chain", "data") mesh
over `jax.devices()` (all hosts' devices), and calls `run_mcmc(...,
mesh=mesh)` with identical arguments.  GSPMD partitions the chains axis
across hosts (pure DP over replicas — zero inter-device traffic in the
step) and the loci axis within hosts; the only cross-host collectives are
the R-hat/ESS reductions at the end.  There is no communication on the
step-loop critical path.  scripts/measure_multihost_scaling.py measures
weak scaling with core-pinned CPU processes over localhost grpc; a GPU
multi-host number is not measured.
"""

from __future__ import annotations

import jax


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None) -> None:
    """`jax.distributed.initialize` passthrough; on single-host no-op.

    Pass the coordinator address, process count and process id
    explicitly."""
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_chain_mesh(n_data_shards: int = 1):
    """The canonical multi-host mesh: all global devices, chains-major."""
    from instruct_jax.parallel.mesh import make_mesh
    return make_mesh(None, n_data_shards)
