"""Device-resident genotype panel representation.

The reference stores genotypes as a ragged `int ***seqdata` plus missing-data
masks built in data_interface.c (get_missing, data_interface.c:812-846).  The
device layout is a dense, statically-shaped tensor pack whose big arrays
always keep a long axis trailing, so reductions and kernel tiles run along
the loci axis and no small ploidy axis sits in the fastest-varying
dimension.  Allele copies are therefore stored *flat*: S = L * ploid with
site index s = copy * L + l (copy-major: per-copy [N, L] planes are
contiguous column slices, so both XLA and Pallas kernels address one copy
as a plain block instead of a strided gather).

  * ``geno``        int8[N, S] — allele codes in [0, A); 0 where missing.
                    int8 because A < 128 always holds and the genotype
                    tensor is read by every hot kernel — 4x less HBM
                    traffic than int32 on the N*L*ploid passes.
  * ``site_valid``  bool[N, L]  — observed AND polymorphic locus.
                    Mirrors `missindx[i][j]!=1 && allelenum[j]>1`
                    (mcmc.c:817, 1137).
  * ``allele_valid`` bool[L, A] — per-locus padding mask over alleles.
  * ``hom``         bool[N, L]  — all copies identical; precomputes
                    `chcksame(seqdata[i][j])` (mcmc.c:1658-1667).
  * ``distinct``    int32[N, 4 * L] copy-major (slot-m block at columns
                    [m*L, (m+1)*L)) — tetraploid-only: the observed sorted
                    set of distinct alleles (transform_data2,
                    data_interface.c:571-669); ordered genotype is latent.
  * ``n_distinct``  int32[N, L] — `alleleid` counts.
  * ``bits2``       int8[N, L] — diploid-biallelic only: the whole site
                    packed into one plane (bit0 = copy-0 allele, bit1 =
                    copy-1 allele, bit2 = site_valid; hom falls out as
                    bit0 == bit1).  The fused Pallas site kernels read this
                    single plane instead of four (geno x2, valid, hom) —
                    one quarter of the site-tensor HBM traffic on the
                    flagship biallelic panels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax.numpy as jnp
import numpy as np


class Dataset(NamedTuple):
    """The jit-traversable pytree of panel tensors."""

    geno: jnp.ndarray          # int8[N, S], S = L * ploid
    site_valid: jnp.ndarray    # bool[N, L]
    allele_valid: jnp.ndarray  # bool[L, A]
    hom: jnp.ndarray           # bool[N, L]
    distinct: Optional[jnp.ndarray] = None      # int32[N, L*4] (tetra)
    n_distinct: Optional[jnp.ndarray] = None    # int32[N, L]
    bits2: Optional[jnp.ndarray] = None         # int8[N, L] (diploid A=2)

    @property
    def n_indv(self) -> int:
        return self.geno.shape[0]

    @property
    def n_loci(self) -> int:
        return self.site_valid.shape[1]

    @property
    def ploid(self) -> int:
        return self.geno.shape[1] // self.site_valid.shape[1]

    @property
    def max_alleles(self) -> int:
        return self.allele_valid.shape[1]

    @property
    def geno3(self) -> np.ndarray:
        """Host-side [N, L, ploid] view for tests/reporting."""
        n = self.geno.shape[0]
        return (np.asarray(self.geno).reshape(n, self.ploid, self.n_loci)
                .transpose(0, 2, 1))


def make_dataset(geno: np.ndarray, missing: np.ndarray,
                 n_alleles: Optional[np.ndarray] = None,
                 distinct: Optional[np.ndarray] = None,
                 n_distinct: Optional[np.ndarray] = None) -> Dataset:
    """Build a :class:`Dataset` from host arrays.

    ``geno`` int[N, L, ploid] with allele codes (missing entries arbitrary),
    ``missing`` bool[N, L] marks loci unobserved for an individual (any copy
    missing drops the whole site, as in get_missing, data_interface.c:826-833).
    """
    geno = np.asarray(geno, dtype=np.int32)
    missing = np.asarray(missing, dtype=bool)
    n, l, p = geno.shape
    geno = np.where(missing[:, :, None], 0, geno)
    if n_alleles is None:
        n_alleles = np.zeros(l, dtype=np.int32)
        for j in range(l):
            obs = geno[:, j][~missing[:, j]]
            n_alleles[j] = int(obs.max()) + 1 if obs.size else 0
    n_alleles = np.asarray(n_alleles, dtype=np.int32)
    a_max = max(int(n_alleles.max()), 2)
    allele_valid = np.arange(a_max)[None, :] < n_alleles[:, None]
    # Monomorphic / empty loci contribute nothing (mcmc.c:817: allelenum>1).
    site_valid = (~missing) & (n_alleles > 1)[None, :]
    hom = np.all(geno == geno[:, :, :1], axis=2)
    if a_max > 127:
        raise ValueError(f"more than 127 alleles at one locus ({a_max}); "
                         "the int8 genotype layout caps A at 127")
    bits2 = None
    if p == 2 and a_max == 2:
        bits2 = jnp.asarray((geno[:, :, 0] | (geno[:, :, 1] << 1)
                             | (site_valid.astype(np.int32) << 2))
                            .astype(np.int8))
    return Dataset(
        geno=jnp.asarray(geno.transpose(0, 2, 1).reshape(n, p * l)
                         .astype(np.int8)),
        site_valid=jnp.asarray(site_valid),
        allele_valid=jnp.asarray(allele_valid),
        hom=jnp.asarray(hom),
        distinct=(None if distinct is None
                  else jnp.asarray(np.asarray(distinct, np.int32)
                                   .transpose(0, 2, 1).reshape(n, -1))),
        n_distinct=(None if n_distinct is None
                    else jnp.asarray(n_distinct, dtype=jnp.int32)),
        bits2=bits2,
    )


@dataclasses.dataclass
class Panel:
    """Host-side panel: the device Dataset plus human metadata.

    Mirrors what SEQDATA carries beyond the genotype tensor: individual
    labels (`indvname`), pre-defined population index/names (`popindx`,
    `poptype`, data_interface.c:147-216), marker names, and allele-type
    string tables used by the report writer (result_analysis.c:349).
    """

    data: Dataset
    indv_names: Optional[Sequence[str]] = None
    pop_index: Optional[np.ndarray] = None      # int[N] pre-defined pop
    pop_names: Optional[Sequence[str]] = None
    marker_names: Optional[Sequence[str]] = None
    allele_names: Optional[Sequence[Sequence[str]]] = None  # per locus
    n_alleles: Optional[np.ndarray] = None

    @property
    def n_indv(self) -> int:
        return self.data.n_indv

    @property
    def n_loci(self) -> int:
        return self.data.n_loci

    @property
    def missing_per_indv(self) -> np.ndarray:
        """`missvec` (data_interface.c:819-834): # missing loci per indiv."""
        return np.asarray(~np.asarray(self.data.site_valid),
                          dtype=np.int64).sum(1)

    @property
    def n_predefined_pops(self) -> int:
        if self.pop_index is None:
            return 1
        return int(np.max(self.pop_index)) + 1
