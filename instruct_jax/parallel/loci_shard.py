"""Loci-axis sharding layout for the explicit shard_map SPMD step.

The model is conditionally independent across loci given (Z, Q, P)
(survey §2.2: every per-locus loop of the reference — update_P's count
loop mcmc.c:815-845, update_ZQ mcmc.c:1135-1174, log_ld_indv
mcmc.c:1735-1770 — is pointwise in L), so the natural tensor-parallel
decomposition splits the loci axis L into contiguous per-device blocks.
Each device owns a fully local sub-panel (its own [N, ploid*L_loc]
copy-major site tensors); the only cross-device traffic per MCMC step is

  * psum of the per-individual pop counts  [N, K]   (before the Q draw),
  * psum of the MH log-ratio columns       [N] or [K] (G / S / F accepts),
  * psum of the per-individual log-liks    [N]      (cal_lkh, stored steps),

all tiny compared to the local [N, L_loc] site passes, and all XLA `psum`
collectives.  This is the explicit (shard_map) alternative
to GSPMD auto-partitioning: it keeps the fused Pallas kernels usable
(GSPMD cannot partition custom calls) and makes the collective set
auditable.

Layout contract: the loci axis is padded to a multiple of the shard count
(padding loci have site_valid == False and allele_valid == False, so they
contribute nothing anywhere), then split contiguously.  Stacked tensors
carry a leading shard axis consumed by shard_map in_specs P(DATA_AXIS).

Sharded-run site tensors (z) that leave the shard_map region are in
"blocked" layout: the global [N, ploid*L] axis is the concatenation of the
shards' local copy-major blocks.  :func:`unblock_sites` converts back to
the standard copy-major global layout; :func:`block_sites` is its inverse
(used when feeding a restored checkpoint back into the sharded program).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from instruct_jax.data.dataset import Dataset


def pad_loci(data: Dataset, n_shards: int) -> Dataset:
    """Pad the loci axis so L % n_shards == 0; padded loci are invalid.
    (Diploid panels; tetraploid panels go through the class-uniform
    :func:`stack_loci_tetra` layout instead.)"""
    l = data.n_loci
    pad = -l % n_shards
    if pad == 0:
        return data
    n, p = data.n_indv, data.ploid
    geno3 = jnp.reshape(data.geno, (n, p, l))
    geno3 = jnp.pad(geno3, ((0, 0), (0, 0), (0, pad)))
    return Dataset(
        geno=geno3.reshape(n, p * (l + pad)),
        site_valid=jnp.pad(data.site_valid, ((0, 0), (0, pad))),
        allele_valid=jnp.pad(data.allele_valid, ((0, pad), (0, 0))),
        hom=jnp.pad(data.hom, ((0, 0), (0, pad))),
        bits2=(None if data.bits2 is None
               else jnp.pad(data.bits2, ((0, 0), (0, pad)))),
    )


def stack_loci(data: Dataset, n_shards: int) -> Dataset:
    """Split the (padded) panel into ``n_shards`` contiguous loci blocks,
    stacked on a new leading axis for shard_map's P(DATA_AXIS) in_specs.

    Each [shard] slice is a self-contained local panel with
    L_loc = L / n_shards loci in standard copy-major layout.
    Tetraploid panels (``distinct`` present) dispatch to the
    class-uniform layout of :func:`stack_loci_tetra`.
    """
    if data.distinct is not None:
        return stack_loci_tetra(data, n_shards)
    data = pad_loci(data, n_shards)
    n, l, p = data.n_indv, data.n_loci, data.ploid
    ll = l // n_shards
    geno = (jnp.reshape(data.geno, (n, p, n_shards, ll))
            .transpose(2, 0, 1, 3).reshape(n_shards, n, p * ll))

    def split_l1(x):  # [N, L] -> [S, N, L_loc]
        return jnp.reshape(x, (n, n_shards, ll)).transpose(1, 0, 2)

    return Dataset(
        geno=geno,
        site_valid=split_l1(data.site_valid),
        allele_valid=(jnp.reshape(data.allele_valid,
                                  (n_shards, ll, data.max_alleles))),
        hom=split_l1(data.hom),
        bits2=None if data.bits2 is None else split_l1(data.bits2),
    )


def tetra_shard_plan(data: Dataset, n_shards: int) -> np.ndarray:
    """src i64[n_shards, L_loc]: global locus index of each shard-local
    column (-1 = synthetic padding locus), under the CLASS-UNIFORM layout.

    The tetraploid engine embeds *static* per-allele-count class
    structure in its compiled step (the per-class loci groupings that
    batch the selfing-equilibrium solves, tetra/engine.py:class_loci);
    shard_map traces ONE program for every shard, so all shards must
    share that structure.  The plan sorts loci by allele count, pads each
    class to a multiple of n_shards, and deals each class's loci in
    contiguous per-shard chunks: class c occupies the same local column
    range [offset_c, offset_c + m_c) on every shard."""
    n_all = np.asarray(data.allele_valid).sum(-1).astype(np.int64)
    shard_src = [[] for _ in range(n_shards)]
    for v in sorted(set(n_all.tolist())):
        idx = np.nonzero(n_all == v)[0]
        m = -(-len(idx) // n_shards)
        padded = np.concatenate(
            [idx, np.full(m * n_shards - len(idx), -1, np.int64)])
        for s in range(n_shards):
            shard_src[s].extend(padded[s * m:(s + 1) * m].tolist())
    return np.asarray(shard_src, np.int64)


def _shard_class_counts(data: Dataset, src: np.ndarray) -> np.ndarray:
    """cnt i64[n_shards, L_loc]: the allele count of each local column's
    CLASS — identical across shards by construction, including padding
    columns (which must inherit the class being padded, NOT locus 0's
    count, or the shard-0-built tables would not describe every shard)."""
    n_all = np.asarray(data.allele_valid).sum(-1).astype(np.int64)
    n_shards, ll = src.shape
    cnt = np.empty((n_shards, ll), np.int64)
    real = src >= 0
    cnt[real] = n_all[src[real]]
    # every shard has the same class layout: fill each shard's padding
    # from shard 0's column classes (shard 0 never holds padding before
    # the last chunk of a class, but guard via a cross-shard max)
    col_class = cnt.copy()
    col_class[~real] = -1
    col_fill = col_class.max(axis=0)           # [L_loc], -1-free by design
    for s in range(n_shards):
        cnt[s, ~real[s]] = col_fill[~real[s]]
    return cnt


def stack_loci_tetra(data: Dataset, n_shards: int) -> Dataset:
    """Tetraploid counterpart of :func:`stack_loci`: per-shard local
    panels under the class-uniform permutation of :func:`tetra_shard_plan`
    (padding loci carry their class's allele count in allele_valid but
    site_valid False / n_distinct 1, so they contribute nothing).

    Loci are PERMUTED relative to the input panel — posterior summaries
    of per-locus quantities (P) must be mapped back through the plan;
    chain-level summaries (S, Q, log-lik, WAIC) are unaffected."""
    src = tetra_shard_plan(data, n_shards)                   # [S, L_loc]
    cls_cnt = _shard_class_counts(data, src)                 # [S, L_loc]
    n = data.n_indv
    a = data.max_alleles
    l = data.n_loci
    geno3 = np.asarray(data.geno).reshape(n, 4, l)
    dist3 = np.asarray(data.distinct).reshape(n, 4, l)
    sv = np.asarray(data.site_valid)
    hom = np.asarray(data.hom)
    nd = np.asarray(data.n_distinct)

    genos, dists, svs, homs, avs, nds = [], [], [], [], [], []
    for s in range(n_shards):
        cols = src[s]
        safe = np.where(cols >= 0, cols, 0)
        pad = cols < 0
        g = geno3[:, :, safe].copy()
        d = dist3[:, :, safe].copy()
        g[:, :, pad] = 0
        d[:, :, pad] = 0
        svx = sv[:, safe].copy()
        svx[:, pad] = False
        hx = hom[:, safe].copy()
        hx[:, pad] = True
        ndx = nd[:, safe].copy()
        ndx[:, pad] = 1
        # padding loci inherit the CLASS's allele count (not locus 0's —
        # that broke the cross-shard identical-class invariant on
        # mixed-allele-count panels; round-5 self-review finding)
        avx = np.arange(a)[None, :] < cls_cnt[s][:, None]
        ll = cols.shape[0]
        genos.append(g.reshape(n, 4 * ll))
        dists.append(d.reshape(n, 4 * ll))
        svs.append(svx)
        homs.append(hx)
        avs.append(avx)
        nds.append(ndx)
    return Dataset(
        geno=jnp.asarray(np.stack(genos).astype(np.int8)),
        site_valid=jnp.asarray(np.stack(svs)),
        allele_valid=jnp.asarray(np.stack(avs)),
        hom=jnp.asarray(np.stack(homs)),
        distinct=jnp.asarray(np.stack(dists).astype(np.int32)),
        n_distinct=jnp.asarray(np.stack(nds).astype(np.int32)),
    )


def local_view(stacked: Dataset) -> Dataset:
    """The per-device panel inside the shard_map body (leading axis 1)."""
    return Dataset(
        geno=stacked.geno[0],
        site_valid=stacked.site_valid[0],
        allele_valid=stacked.allele_valid[0],
        hom=stacked.hom[0],
        distinct=None if stacked.distinct is None else stacked.distinct[0],
        n_distinct=(None if stacked.n_distinct is None
                    else stacked.n_distinct[0]),
        bits2=None if stacked.bits2 is None else stacked.bits2[0],
    )


def unblock_sites(x, n_shards: int, ploid: int):
    """Blocked-global site tensor [..., n_shards * ploid * L_loc] (shard-
    major concatenation of local copy-major blocks) -> standard copy-major
    [..., ploid * L] with L = n_shards * L_loc."""
    x = np.asarray(x)
    lead = x.shape[:-1]
    ll = x.shape[-1] // (n_shards * ploid)
    x = x.reshape(*lead, n_shards, ploid, ll)
    order = tuple(range(len(lead)))
    x = x.transpose(*order, len(lead) + 1, len(lead), len(lead) + 2)
    return x.reshape(*lead, ploid * n_shards * ll)


def block_sites(x, n_shards: int, ploid: int):
    """Inverse of :func:`unblock_sites`."""
    x = np.asarray(x)
    lead = x.shape[:-1]
    ll = x.shape[-1] // (n_shards * ploid)
    x = x.reshape(*lead, ploid, n_shards, ll)
    order = tuple(range(len(lead)))
    x = x.transpose(*order, len(lead) + 1, len(lead), len(lead) + 2)
    return x.reshape(*lead, ploid * n_shards * ll)
