"""DPM (CRP) prior tests: table invariants, cluster-count distribution vs
the CRP's E[#tables] = sum alpha/(alpha+i), and end-to-end runs for modes
3 and 5 with the DP prior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec, Priors, PriorFamily, Schedule
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.mcmc import dpm
from instruct_jax.mcmc.driver import run_mcmc


def table_ok(t: dpm.DpmTable, n):
    counts = np.asarray(t.counts)
    assign = np.asarray(t.assign)
    assert counts.sum() == n
    # every individual's slot is occupied and its count is consistent
    occ = np.bincount(assign, minlength=n)
    np.testing.assert_array_equal(occ, counts)
    # occupied tables have values in [0, 1]
    vals = np.asarray(t.values)[counts > 0]
    assert ((vals >= 0) & (vals <= 1)).all()


def test_init_dpm_invariants_and_cluster_count():
    n, alpha = 200, 5.0
    tables = []
    for seed in range(20):
        t = dpm.init_dpm(jax.random.key(seed), alpha, n)
        table_ok(t, n)
        tables.append(int((np.asarray(t.counts) > 0).sum()))
    expect = sum(alpha / (alpha + i) for i in range(n))
    assert abs(np.mean(tables) - expect) < 0.25 * expect


def test_crp_sweep_selfing_invariants():
    n = 50
    t = dpm.init_dpm(jax.random.key(0), 2.0, n)
    gen = jnp.asarray(np.random.default_rng(0).integers(1, 20, n))
    for i in range(5):
        t = dpm.crp_sweep_selfing(jax.random.key(i + 1), t, gen, 2.0)
        table_ok(t, n)


def test_crp_selfing_clusters_by_generation():
    # Individuals with high G should land on high-S tables: after sweeps
    # conditioning on G, the table value for high-G individuals must exceed
    # that of low-G ones (Beta(g,2) has mean g/(g+2)).
    n = 60
    gen = jnp.asarray([2] * 30 + [40] * 30)
    t = dpm.init_dpm(jax.random.key(5), 1.0, n)
    for i in range(30):
        t = dpm.crp_sweep_selfing(jax.random.key(100 + i), t, gen, 1.0)
    rates = np.asarray(t.values)[np.asarray(t.assign)]
    assert rates[30:].mean() - rates[:30].mean() > 0.3


def test_f_loglik_grid_matches_pointwise():
    panel = synthetic_panel(n_indv=6, n_loci=9, n_pops=2, seed=2)
    data = panel.data
    rng = np.random.default_rng(1)
    n, l, p = data.geno3.shape
    freq = jnp.asarray(rng.dirichlet(np.ones(2), size=(2, l)), jnp.float32)
    z = jnp.asarray(rng.integers(0, 2, (n, l * p)))
    m = 16
    grid = (np.arange(m) + 0.5) / m
    got = np.asarray(dpm.f_loglik_grid(ModelSpec(mode=5, n_pops=2), data,
                                       freq, z, m=m))
    # brute force with the site formulas
    from instruct_jax.model import likelihood as lk
    for mi in [0, 7, 15]:
        f = jnp.full((n,), grid[mi], jnp.float32)
        pz = lk.gather_freq_at_z(freq, data, z)
        p0, p1 = lk.split_copies(pz, p)
        z0, z1 = lk.split_copies(z, p)
        mask = np.asarray(z0 == z1) & np.asarray(data.site_valid)
        site = np.log(np.maximum(np.asarray(
            lk.genofreq_inbreeding(p0, p1, data.hom, f[:, None])), 1e-30))
        want = np.where(mask, site, 0.0).sum(1)
        np.testing.assert_allclose(got[:, mi], want, rtol=1e-4, atol=1e-4)


def test_f_loglik_grid_matmul_matches_dense():
    # The masked-matmul formulation must reproduce the dense [N, L, M]
    # contraction exactly (up to matmul summation order), including
    # multiallelic loci and missing sites.
    panel = synthetic_panel(n_indv=23, n_loci=40, n_pops=3, seed=11,
                            n_alleles=4, missing_rate=0.1)
    data = panel.data
    rng = np.random.default_rng(3)
    n, l, p = data.geno3.shape
    a = data.max_alleles
    freq = jnp.asarray(rng.dirichlet(np.ones(a), size=(3, l)), jnp.float32)
    z = jnp.asarray(rng.integers(0, 3, (n, l * p)))
    spec = ModelSpec(mode=5, n_pops=3)
    got = np.asarray(dpm.f_loglik_grid(spec, data, freq, z, m=32))
    want = np.asarray(dpm.f_loglik_grid_dense(spec, data, freq, z, m=32))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("mode", [3, 5])
def test_dpm_mode_runs_end_to_end(mode):
    panel = synthetic_panel(n_indv=14, n_loci=10, n_pops=2, seed=mode)
    spec = ModelSpec(mode=mode, n_pops=2,
                     priors=Priors(family=PriorFamily.DPM, alpha_dpm=3.0))
    sched = Schedule(n_iter=40, burnin=20, thinning=2, n_chains=2, ckrep=5,
                     nstep_check_empty_cluster=5)
    res = run_mcmc(panel.data, spec, sched, jax.random.key(0))
    assert np.isfinite(np.asarray(res.accum.mean.total_ll)).all()
    rates = np.asarray(res.accum.mean.rates)
    assert rates.shape == (2, 14)
    assert ((rates >= 0) & (rates <= 1)).all()


@pytest.mark.parametrize("mode", [3, 5])
def test_normal_prior_runs_end_to_end(mode):
    panel = synthetic_panel(n_indv=10, n_loci=8, n_pops=2, seed=mode + 7)
    spec = ModelSpec(mode=mode, n_pops=2,
                     priors=Priors(family=PriorFamily.NORMAL))
    sched = Schedule(n_iter=40, burnin=20, thinning=2, n_chains=2, ckrep=5,
                     nstep_check_empty_cluster=5)
    res = run_mcmc(panel.data, spec, sched, jax.random.key(1))
    assert np.isfinite(np.asarray(res.accum.mean.total_ll)).all()


def test_stick_sweep_selfing_clusters_by_generation():
    # Blocked (truncated stick-breaking) sampler: same recovery as the CRP
    # sweep — high-G individuals on high-S tables — with fully parallel
    # reseating.
    n = 60
    gen = jnp.asarray([2] * 30 + [40] * 30)
    t = dpm.init_dpm(jax.random.key(5), 1.0, n)
    for i in range(30):
        t = dpm.stick_sweep_selfing(jax.random.key(200 + i), t, gen, 1.0,
                                    t_max=16)
    rates = np.asarray(t.values)[np.asarray(t.assign)]
    assert rates[30:].mean() - rates[:30].mean() > 0.3
    counts = np.asarray(t.counts)
    assert counts.sum() == n
    occ = np.bincount(np.asarray(t.assign), minlength=n)
    np.testing.assert_array_equal(occ, counts)


def test_stick_vs_crp_posterior_agreement():
    # Both DP samplers target (nearly) the same posterior: the mean rate of
    # the high-G block must agree across samplers within MC error.
    n = 60
    gen = jnp.asarray([3] * 30 + [25] * 30)

    def run(sweep, seed0):
        t = dpm.init_dpm(jax.random.key(9), 2.0, n)
        draws = []
        for i in range(60):
            t = sweep(jax.random.key(seed0 + i), t)
            if i >= 20:
                draws.append(np.asarray(t.values)[np.asarray(t.assign)])
        return np.stack(draws).mean(0)

    crp = run(lambda k, t: dpm.crp_sweep_selfing(k, t, gen, 2.0), 1000)
    stk = run(lambda k, t: dpm.stick_sweep_selfing(k, t, gen, 2.0,
                                                   t_max=24), 2000)
    np.testing.assert_allclose(stk[30:].mean(), crp[30:].mean(), atol=0.08)
    np.testing.assert_allclose(stk[:30].mean(), crp[:30].mean(), atol=0.08)


def test_run_mcmc_mode3_dpm_truncated():
    panel = synthetic_panel(n_indv=40, n_loci=60, n_pops=2, seed=6,
                            selfing_rates=np.array([0.2, 0.7]))
    spec = ModelSpec(mode=3, n_pops=2,
                     priors=Priors(family=PriorFamily.DPM, alpha_dpm=2.0,
                                   dp_truncation=16))
    sched = Schedule(n_iter=300, burnin=150, thinning=5, n_chains=2,
                     ckrep=10, nstep_check_empty_cluster=10)
    res = run_mcmc(panel.data, spec, sched, jax.random.key(0))
    rates = np.asarray(res.posterior_mean.rates)
    assert rates.shape == (2, 40)
    assert np.isfinite(np.asarray(res.posterior_mean.total_ll)).all()
    assert ((rates >= 0) & (rates <= 1)).all()


def test_dp_truncation_validated():
    """dp_truncation outside [0, N] (or ==1) must fail with a clear
    ValueError, not a trace-time shape mismatch (ADVICE r1)."""
    import pytest

    from instruct_jax.config import PriorFamily, Priors
    from instruct_jax.mcmc.dpm import build_dpm_update

    panel = synthetic_panel(n_indv=12, n_loci=6, n_pops=2, seed=0)
    for bad in (-1, 1, 13, 10_000):
        spec = ModelSpec(mode=3, n_pops=2,
                         priors=Priors(family=PriorFamily.DPM,
                                       dp_truncation=bad))
        with pytest.raises(ValueError, match="dp_truncation"):
            build_dpm_update(spec, panel.data)
    ok = ModelSpec(mode=3, n_pops=2,
                   priors=Priors(family=PriorFamily.DPM, dp_truncation=8))
    build_dpm_update(ok, panel.data)   # in range: no error
