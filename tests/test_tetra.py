"""Tetraploid engine tests: combinatoric tables vs the reference's closed
forms, selfing-equilibrium invariants, and end-to-end auto/allo runs."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.synthetic import synthetic_tetra_panel
from instruct_jax.mcmc.driver import run_mcmc
from instruct_jax.tetra import combinatorics as comb
from instruct_jax.tetra.engine import (build_tables, log_hwe_table,
                                       selfing_equilibrium)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_auto_class_counts_match_reference(n):
    # auto_geno_num (poly_geno.c:1698-1715)
    cls = comb._auto_classes(n)
    assert len(cls) == (n + n * (n - 1) * 3 // 2
                        + n * (n - 1) * (n - 2) // 2
                        + n * (n - 1) * (n - 2) * (n - 3) // 24)
    assert len(set(cls)) == len(cls)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_allo_class_counts_match_reference(n):
    # allo_geno_num (poly_geno.c:2031-2047)
    cls = comb._allo_classes(n)
    assert len(cls) == (n * n + n * (n - 1) * n
                        + n * n * (n - 1) * (n - 1) // 4)
    assert len(set(cls)) == len(cls)


def test_selfing_matrix_auto_reference_coefficients():
    """Diagonals must equal the reference's hand-coded staged coefficients
    (poly_geno.c dead-code full matrix, 2692-2894): mono 1, simplex 1/2,
    duplex 1/2, triallele 10/36, quadriallele 1/6."""
    ct = comb.build_class_tables(np.array([4]), autopoly=True)
    g = int(ct.g_count[0])
    a = ct.self_mat[0, :g, :g]
    # columns are offspring distributions
    np.testing.assert_allclose(a.sum(axis=0), 1.0, atol=1e-6)
    diag_expect = {1: 1.0, 2: None, 3: None, 4: None}
    for gi in range(g):
        tup = tuple(ct.digits[0, gi])
        kinds = len(set(tup))
        counts = sorted(tup.count(x) for x in set(tup))
        if kinds == 1:
            want = 1.0
        elif kinds == 2 and counts == [1, 3]:
            want = 0.5
        elif kinds == 2 and counts == [2, 2]:
            want = 0.5
        elif kinds == 3:
            want = 10.0 / 36.0
        else:
            want = 1.0 / 6.0
        assert a[gi, gi] == pytest.approx(want, abs=1e-6), tup


def test_selfing_matrix_allo_reference_coefficients():
    """(ii)(kk) 1, (ii)(kl) 1/2, (ij)(kk) 1/2, (ij)(kl) 1/4
    (poly_geno.c dead-code, 2920-3036)."""
    ct = comb.build_class_tables(np.array([3]), autopoly=False)
    g = int(ct.g_count[0])
    a = ct.self_mat[0, :g, :g]
    np.testing.assert_allclose(a.sum(axis=0), 1.0, atol=1e-6)
    for gi in range(g):
        tup = tuple(ct.digits[0, gi])
        het1 = tup[0] != tup[1]
        het2 = tup[2] != tup[3]
        want = {(False, False): 1.0, (False, True): 0.5,
                (True, False): 0.5, (True, True): 0.25}[(het1, het2)]
        assert a[gi, gi] == pytest.approx(want, abs=1e-6), tup


def test_lookup_table_consistency():
    ct = comb.build_class_tables(np.array([3]), autopoly=True)
    g = int(ct.g_count[0])
    for tup in itertools.product(range(3), repeat=4):
        ci = ct.lookup[0, comb._pack(tup, ct.n_max)]
        canon = tuple(ct.digits[0, ci])
        assert sorted(canon) == sorted(tup)
        assert 0 <= ci < g


def test_equilibrium_biallelic_closed_form():
    """Biallelic autotetraploid duplex: at selfing equilibrium the reference
    recursion gives P(iijj) = [(1-s) R + s-terms]/(1 - s/2); with only two
    alleles the class set is tiny and the solve must satisfy the stationary
    equation P = (1-s) R + s A P column-wise."""
    panel = synthetic_tetra_panel(n_indv=4, n_loci=3, n_pops=1,
                                  autopoly=True, seed=1)
    spec = ModelSpec(mode=2, ploid=4, n_pops=1)
    tables = build_tables(spec, panel.data)
    k = 1
    rng = np.random.default_rng(0)
    freq = jnp.asarray(rng.dirichlet(np.ones(2), size=(k, 3)), jnp.float32)
    log_hwe = log_hwe_table(tables, spec, freq, freq)
    for s_val in [0.0, 0.3, 0.9]:
        s = jnp.full((k,), s_val)
        out = selfing_equilibrium(tables, log_hwe, s)
        p = np.exp(np.asarray(out[0]))        # [L, G] (pop 0)
        g = int(np.asarray(tables.gvalid[0]).sum())
        p = p[:, :g]
        np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-4)
        a = np.asarray(tables.self_mat[0, :g, :g])
        r = np.exp(np.asarray(log_hwe[0, :, :g]))
        want = (1 - s_val) * r + s_val * (p @ a.T)
        np.testing.assert_allclose(p, want, atol=1e-4)
        if s_val == 0.0:
            np.testing.assert_allclose(p, r, atol=1e-5)


@pytest.mark.parametrize("autopoly", [True, False])
def test_tetra_end_to_end(autopoly):
    panel = synthetic_tetra_panel(n_indv=12, n_loci=8, n_pops=2,
                                  autopoly=autopoly, missing_rate=0.1,
                                  seed=3)
    spec = ModelSpec(mode=2, ploid=4, n_pops=2, autopoly=autopoly)
    sched = Schedule(n_iter=40, burnin=20, thinning=2, n_chains=2, ckrep=5,
                     nstep_check_empty_cluster=5)
    res = run_mcmc(panel.data, spec, sched, jax.random.key(0))
    total = np.asarray(res.accum.mean.total_ll)
    assert np.isfinite(total).all() and (total < 0).all()
    q = np.asarray(res.accum.mean.q)
    np.testing.assert_allclose(q.sum(-1), 1.0, atol=1e-3)
    assert res.accum.mean.rates.shape == (2, 2)


def test_tetra_recovers_selfing_rate():
    # One pop, strong signal: equilibrium data at s=0.8 vs s=0.05.
    for s_true in [0.05, 0.8]:
        panel = synthetic_tetra_panel(n_indv=80, n_loci=60, n_pops=1,
                                      selfing_rates=np.array([s_true]),
                                      autopoly=True, seed=11)
        spec = ModelSpec(mode=2, ploid=4, n_pops=1)
        sched = Schedule(n_iter=400, burnin=150, thinning=2, n_chains=1,
                         ckrep=20, nstep_check_empty_cluster=10)
        res = run_mcmc(panel.data, spec, sched, jax.random.key(5))
        s_hat = float(np.asarray(res.accum.mean.rates)[0, 0])
        assert abs(s_hat - s_true) < 0.2, (s_true, s_hat)


def test_equilibrium_matches_forward_simulation():
    """Independent validation of the selfing-equilibrium solve: simulate the
    renewal process directly (HWE draw, then g-1 explicit gamete-pair
    selfing steps with g ~ Geometric(1-s)) and compare genotype-class
    frequencies.  This does NOT use the A matrix, so it independently
    verifies the gamete-enumeration math — and pins down the reference's
    missing simplex->duplex flow (see
    test_parity_reference.test_tetraploid_no_reference_parity_by_design)."""
    rng = np.random.default_rng(0)
    p = np.array([0.3, 0.7])
    s = 0.6
    ct = comb.build_class_tables(np.array([2]), autopoly=True)
    g = int(ct.g_count[0])
    a_mat = ct.self_mat[0, :g, :g]
    digits = ct.digits[0, :g]
    logr = ct.log_mult[0, :g].astype(float).copy()
    for slot in range(4):
        logr += np.log(p[digits[:, slot]])
    r = np.exp(logr)
    p_eq = (1 - s) * np.linalg.solve(np.eye(g) - s * a_mat, r)

    pairs = list(itertools.combinations(range(4), 2))
    m = 60000
    geno = rng.choice(2, size=(m, 4), p=p)
    gg = rng.geometric(1 - s, size=m)
    for t in range(1, int(gg.max())):
        idx = (gg > t).nonzero()[0]
        if idx.size == 0:
            break
        pr = rng.integers(0, 6, size=(idx.size, 2))
        for ai, (i1, j1) in enumerate(pairs):
            for bi, (i2, j2) in enumerate(pairs):
                sel = idx[(pr[:, 0] == ai) & (pr[:, 1] == bi)]
                geno[sel] = np.stack([geno[sel, i1], geno[sel, j1],
                                      geno[sel, i2], geno[sel, j2]], 1)
    counts = np.zeros(g)
    lookup = ct.lookup[0]
    for row in geno:
        counts[lookup[comb._pack(tuple(row), ct.n_max)]] += 1
    np.testing.assert_allclose(counts / m, p_eq, atol=0.01)
