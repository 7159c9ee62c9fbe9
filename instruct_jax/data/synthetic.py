"""Synthetic genotype panels for tests and benchmarks.

Generates data from the generative model itself (admixture + partial
selfing), so posterior checks have a known ground truth.  The reference has
no such generator; its example datasets are ad-hoc files.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from instruct_jax.data.dataset import Dataset, Panel, make_dataset


def synthetic_panel(
    n_indv: int = 100,
    n_loci: int = 100,
    n_pops: int = 2,
    n_alleles: int = 2,
    ploid: int = 2,
    selfing_rates: Optional[np.ndarray] = None,
    admixture_alpha: float = 0.2,
    missing_rate: float = 0.0,
    seed: int = 0,
) -> Panel:
    """Draw a panel from the mode-2 generative model.

    For each subpop k and locus l: p_kl ~ Dirichlet(1,...,1).
    For each individual: q_i ~ Dirichlet(alpha), selfing generations
    g_i ~ Geometric(1 - qbar_i @ S) capped at 50 (mcmc.c:196-199), then each
    locus draws z-copies ~ Cat(q_i) and alleles; with probability controlled
    by g_i the two copies coalesce into a homozygote, matching the
    partial-selfing genotype frequencies of genofreq() (mcmc.c:1683-1703).
    """
    rng = np.random.default_rng(seed)
    if selfing_rates is None:
        selfing_rates = np.linspace(0.1, 0.8, n_pops)
    selfing_rates = np.asarray(selfing_rates, dtype=np.float64)

    freq = rng.dirichlet(np.ones(n_alleles), size=(n_pops, n_loci))
    q = rng.dirichlet(np.full(n_pops, admixture_alpha), size=n_indv)
    sbar = q @ selfing_rates
    gen = np.minimum(rng.geometric(np.clip(1.0 - sbar, 1e-9, 1.0)), 50)

    geno = np.zeros((n_indv, n_loci, ploid), dtype=np.int32)
    for i in range(n_indv):
        z = rng.choice(n_pops, size=(n_loci, ploid), p=q[i])
        a = np.zeros((n_loci, ploid), dtype=np.int64)
        for c in range(ploid):
            pf = freq[z[:, c], np.arange(n_loci)]
            cum = pf.cumsum(axis=1)
            u = rng.random(n_loci)[:, None]
            a[:, c] = (u > cum).sum(axis=1)
        if ploid == 2:
            # With g generations of selfing, a heterozygote survives with
            # probability 2^{1-g}; otherwise it collapses to one of its
            # alleles (each with prob 1/2) — the stationary intuition behind
            # genofreq() (mcmc.c:1683-1703).
            p_het_survive = 0.5 ** (gen[i] - 1)
            collapse = rng.random(n_loci) > p_het_survive
            pick = rng.integers(0, 2, n_loci)
            a[collapse, 0] = a[collapse, pick[collapse]]
            a[collapse, 1] = a[collapse, 0]
        geno[i] = a
    missing = rng.random((n_indv, n_loci)) < missing_rate
    data = make_dataset(geno, missing, np.full(n_loci, n_alleles, np.int32))
    return Panel(
        data=data,
        indv_names=[f"ind{i}" for i in range(n_indv)],
        pop_index=np.argmax(q, axis=1),
        pop_names=[f"pop{k}" for k in range(n_pops)],
        n_alleles=np.full(n_loci, n_alleles, np.int32),
    )


def synthetic_tetra_panel(
    n_indv: int = 50,
    n_loci: int = 40,
    n_pops: int = 2,
    n_alleles: int = 2,
    autopoly: bool = True,
    selfing_rates: Optional[np.ndarray] = None,
    admixture_alpha: float = 0.1,
    missing_rate: float = 0.0,
    seed: int = 0,
) -> Panel:
    """Tetraploid panel drawn from the engine's own generative model: each
    individual's dominant pop contributes an ordered genotype sampled from
    the *selfing-equilibrium* class distribution (I - sA)P = (1-s)R, and the
    observation is the set of distinct alleles (transform_data2 semantics,
    data_interface.c:571-669)."""
    from instruct_jax.tetra.combinatorics import build_class_tables

    rng = np.random.default_rng(seed)
    if selfing_rates is None:
        selfing_rates = np.linspace(0.1, 0.8, n_pops)
    freq = rng.dirichlet(np.ones(n_alleles), size=(n_pops, n_loci))
    freq2 = rng.dirichlet(np.ones(n_alleles), size=(n_pops, n_loci))
    q = rng.dirichlet(np.full(n_pops, admixture_alpha), size=n_indv)
    pop = np.array([rng.choice(n_pops, p=q[i]) for i in range(n_indv)])

    ct = build_class_tables(np.full(n_loci, n_alleles, np.int32), autopoly)
    g = int(ct.g_count[0])
    digits = ct.digits[0, :g]                                 # [G, 4]
    a_mat = ct.self_mat[0, :g, :g]

    distinct = np.zeros((n_indv, n_loci, 4), np.int32)
    n_distinct = np.zeros((n_indv, n_loci), np.int32)
    for k in range(n_pops):
        s = float(selfing_rates[k])
        inv = np.linalg.inv(np.eye(g) - s * a_mat)
        for j in range(n_loci):
            # HWE class probs R from the digit products + multiplicities
            logr = ct.log_mult[0, :g].astype(np.float64).copy()
            for slot in range(4):
                f = freq if (autopoly or slot < 2) else freq2
                logr += np.log(f[k, j, digits[:, slot]])
            p_cls = (1.0 - s) * inv @ np.exp(logr)
            p_cls = np.maximum(p_cls, 0)
            p_cls /= p_cls.sum()
            idx = (pop == k).nonzero()[0]
            draws = rng.choice(g, size=idx.size, p=p_cls)
            for ii, d in zip(idx, draws):
                alleles = sorted(set(digits[d]))
                n_distinct[ii, j] = len(alleles)
                distinct[ii, j, :len(alleles)] = alleles
    miss = rng.random((n_indv, n_loci)) < missing_rate
    n_distinct = np.where(miss, 0, n_distinct)
    data = make_dataset(distinct, miss,
                        np.full(n_loci, n_alleles, np.int32),
                        distinct=distinct, n_distinct=n_distinct)
    return Panel(data=data,
                 indv_names=[f"ind{i}" for i in range(n_indv)],
                 pop_index=pop,
                 pop_names=[f"pop{k}" for k in range(n_pops)],
                 n_alleles=np.full(n_loci, n_alleles, np.int32))
