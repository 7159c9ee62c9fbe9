"""Device-mesh construction and sharding policies.

The reference has zero parallelism (chains sequential, InStruct.c:182-193).
Here parallelism is declarative: a `jax.sharding.Mesh` with axes

  * ``chain`` — MCMC chains × K-sweep values × SMC particles (replica axis;
    embarrassingly parallel, collectives only for R̂/resampling),
  * ``data``  — the loci axis L (the long axis, conditionally independent
    given (Z, Q, P); survey §2.2).  Per-locus work (P update, Z-Gibbs) is
    local; only per-individual reductions (q-counts, log-liks) cross it and
    XLA/GSPMD inserts the `psum`s automatically from the shardings.

XLA's collectives (NCCL on the GPU) are the communication backend; the
cards of a host are joined all to all, so the mesh follows the algorithm.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from instruct_jax.data.dataset import Dataset

CHAIN_AXIS = "chain"
DATA_AXIS = "data"


def get_shard_map():
    """`shard_map(f, mesh, in_specs, out_specs)` without replication
    checking."""
    def shard_map(f, *, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    return shard_map


def make_mesh(n_chain_shards: Optional[int] = None,
              n_data_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a 2-D ("chain", "data") mesh over the available devices.

    Defaults put every device on the chain axis (the embarrassingly parallel
    direction); pass ``n_data_shards`` to split loci instead/in addition.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_chain_shards is None and n_data_shards is None:
        n_chain_shards, n_data_shards = n, 1
    elif n_chain_shards is None:
        n_chain_shards = n // n_data_shards
    elif n_data_shards is None:
        n_data_shards = n // n_chain_shards
    if n_chain_shards * n_data_shards != n:
        raise ValueError(
            f"mesh {n_chain_shards}x{n_data_shards} != {n} devices")
    dev_array = np.asarray(devices).reshape(n_chain_shards, n_data_shards)
    return Mesh(dev_array, (CHAIN_AXIS, DATA_AXIS))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_dataset(mesh: Mesh, data: Dataset) -> Dataset:
    """Place the panel with the loci axis split over "data".

    geno/site_valid/hom are [N, L, ...]: L is axis 1; allele_valid is [L, A]:
    L is axis 0.  Individuals N stay replicated (chain-parallel scaling is
    the first-order axis; loci sharding kicks in for biobank-scale L).
    """
    along_l1 = NamedSharding(mesh, P(None, DATA_AXIS))
    along_l0 = NamedSharding(mesh, P(DATA_AXIS))
    return Dataset(
        geno=jax.device_put(data.geno, along_l1),
        site_valid=jax.device_put(data.site_valid, along_l1),
        allele_valid=jax.device_put(data.allele_valid, along_l0),
        hom=jax.device_put(data.hom, along_l1),
    )


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for any array whose leading axis is chains."""
    return NamedSharding(mesh, P(CHAIN_AXIS))
