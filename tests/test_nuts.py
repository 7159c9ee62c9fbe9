"""NUTS correctness: exact moments on a correlated Gaussian, and posterior
agreement with the Gibbs engine on a small selfing panel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.samplers.nuts import NutsConfig, nuts_transition, run_nuts


def test_nuts_correlated_gaussian_moments():
    # target: N(mu, Sigma) with strong correlation — U-turn logic must
    # produce the right marginal moments
    mu = jnp.asarray([1.0, -2.0, 0.5])
    cov = jnp.asarray([[1.0, 0.8, 0.2],
                       [0.8, 1.5, -0.3],
                       [0.2, -0.3, 0.7]])
    prec = jnp.linalg.inv(cov)

    def potential(x):
        d = x - mu
        return 0.5 * d @ prec @ d

    cfg = NutsConfig(n_warmup=400, n_samples=1500, max_depth=8,
                     init_step=0.2)
    samples, accept, _ = run_nuts(potential, jnp.zeros(3),
                                  jax.random.key(0), cfg)
    s = np.asarray(samples)
    assert 0.5 < float(accept) <= 1.0
    np.testing.assert_allclose(s.mean(0), np.asarray(mu), atol=0.15)
    emp_cov = np.cov(s.T)
    np.testing.assert_allclose(emp_cov, np.asarray(cov), atol=0.45)


def test_nuts_transition_is_finite_and_moves():
    def potential(x):
        return 0.5 * jnp.sum(x * x)

    grad = jax.value_and_grad(potential)
    pos = jnp.ones(4)
    new, pa = nuts_transition(grad, jnp.ones(4), 0.3, 6, pos,
                              jax.random.key(1))
    assert np.isfinite(np.asarray(new)).all()
    assert 0.0 <= float(pa) <= 1.0
    assert not np.allclose(np.asarray(new), np.asarray(pos))


def test_nuts_selfing_posterior_matches_gibbs():
    from instruct_jax.config import ModelSpec, Schedule
    from instruct_jax.data.synthetic import synthetic_panel
    from instruct_jax.mcmc.driver import run_mcmc
    from instruct_jax.samplers.run import run_sampler

    panel = synthetic_panel(n_indv=40, n_loci=80, n_pops=2,
                            selfing_rates=np.array([0.15, 0.75]), seed=3)
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(n_iter=2000, burnin=1000, thinning=5, n_chains=2,
                     ckrep=50, nstep_check_empty_cluster=100)
    gibbs = run_mcmc(panel.data, spec, sched, jax.random.key(0))
    s_gibbs = np.sort(np.asarray(gibbs.posterior_mean.rates), axis=1).mean(0)   # sort per chain: label switching

    res = run_sampler("nuts", panel.data, spec,
                      Schedule(n_iter=150, burnin=100, thinning=1,
                               n_chains=1, ckrep=10,
                               nstep_check_empty_cluster=10),
                      jax.random.key(1))
    s_nuts = np.sort(res.s_mean)
    np.testing.assert_allclose(s_nuts, s_gibbs, atol=0.12)


@pytest.mark.parametrize("mode", [3, 4, 5])
def test_nuts_posterior_matches_gibbs_modes345(mode):
    # One NUTS-vs-Gibbs agreement check per extended mode family:
    # per-individual selfing (3), pop inbreeding F (4), individual F (5).
    from instruct_jax.config import ModelSpec, Schedule
    from instruct_jax.data.synthetic import synthetic_panel
    from instruct_jax.mcmc.driver import run_mcmc
    from instruct_jax.samplers.run import run_sampler

    panel = synthetic_panel(n_indv=40, n_loci=80, n_pops=2,
                            selfing_rates=np.array([0.1, 0.8]),
                            admixture_alpha=0.05, seed=21)
    spec = ModelSpec(mode=mode, n_pops=2)
    sched = Schedule(n_iter=2000, burnin=1000, thinning=5, n_chains=2,
                     ckrep=50, nstep_check_empty_cluster=100)
    gibbs = run_mcmc(panel.data, spec, sched, jax.random.key(0))
    r_gibbs = np.asarray(gibbs.posterior_mean.rates)        # [C, R]

    res = run_sampler("nuts", panel.data, spec,
                      Schedule(n_iter=150, burnin=100, thinning=1,
                               n_chains=1, ckrep=10,
                               nstep_check_empty_cluster=10),
                      jax.random.key(1))
    if mode == 4:
        # pop-level F: exchangeable cluster labels — compare sorted
        np.testing.assert_allclose(np.sort(res.s_mean),
                                   np.sort(r_gibbs, axis=1).mean(0),
                                   atol=0.15)
    else:
        # per-individual rates: label-free; elementwise + mean agreement.
        # With 80 loci the per-individual marginals are wide (posterior sd
        # ~0.2), so two short-chain estimates differ by ~0.05-0.1 on
        # average even when the samplers agree.
        r_g = r_gibbs.mean(0)
        d = np.abs(res.s_mean - r_g)
        assert d.mean() < 0.12, (d.mean(), d.max())
        assert d.max() < 0.35, d.max()
