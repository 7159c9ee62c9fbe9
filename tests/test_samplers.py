"""Gradient-based samplers (HMC / SVI / SMC) over the marginalized model:
correctness on a known Gaussian target + posterior recovery on synthetic
panels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.samplers.hmc import HmcConfig, run_hmc
from instruct_jax.samplers.potential import MarginalModel
from instruct_jax.samplers.smc import SmcConfig, run_smc
from instruct_jax.samplers.svi import SviConfig, run_svi


def test_hmc_gaussian_target():
    # Standard 2D Gaussian with different scales: HMC must recover moments.
    scales = jnp.asarray([1.0, 3.0])

    def potential(x):
        return 0.5 * jnp.sum((x / scales) ** 2)

    samples, acc, _ = run_hmc(
        potential, jnp.zeros(2), jax.random.key(0),
        HmcConfig(n_warmup=300, n_samples=600, n_leapfrog=8))
    s = np.asarray(samples)
    assert acc > 0.5
    assert abs(s[:, 0].std() - 1.0) < 0.3
    assert abs(s[:, 1].std() - 3.0) < 1.0


def test_svi_gaussian_target():
    mu_true = jnp.asarray([1.0, -2.0])

    def log_joint(x):
        return -0.5 * jnp.sum((x - mu_true) ** 2 / 0.25)

    mu, log_sigma, elbo = run_svi(log_joint, jnp.zeros(2),
                                  jax.random.key(1),
                                  SviConfig(n_steps=800, learning_rate=0.05))
    np.testing.assert_allclose(np.asarray(mu), np.asarray(mu_true),
                               atol=0.15)
    np.testing.assert_allclose(np.exp(np.asarray(log_sigma)), 0.5, atol=0.2)
    assert elbo[-50:].mean() > elbo[:50].mean()


def test_smc_gaussian_marginal_likelihood():
    # prior N(0, 1), likelihood N(x; 1, 1) -> evidence N(1; 0, 2)
    def log_prior(x):
        return -0.5 * jnp.sum(x ** 2) - 0.5 * jnp.log(2 * jnp.pi)

    def log_joint(x):
        return (log_prior(x) - 0.5 * jnp.sum((x - 1.0) ** 2)
                - 0.5 * jnp.log(2 * jnp.pi))

    init = jax.random.normal(jax.random.key(2), (256, 1))
    parts, logz, ess = run_smc(
        log_joint, log_prior, init, jax.random.key(3),
        SmcConfig(n_particles=256, n_temps=15, n_mh_steps=5, rw_scale=0.4))
    want = -0.5 * np.log(2 * np.pi * 2.0) - 0.5 * 1.0 / 2.0
    assert abs(float(logz) - want) < 0.25, (float(logz), want)
    assert float(np.asarray(parts).mean()) == pytest.approx(0.5, abs=0.25)


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(n_indv=40, n_loci=60, n_pops=2, n_alleles=2,
                           selfing_rates=np.array([0.1, 0.8]),
                           admixture_alpha=0.05, seed=77)


@pytest.mark.parametrize("mode", [1, 2, 3, 4, 5])
def test_marginal_model_gradients_finite(panel, mode):
    model = MarginalModel(ModelSpec(mode=mode, n_pops=2), panel.data)
    params = model.init(jax.random.key(0))
    assert params.phi_s.shape == ({1: 0, 2: 2, 3: 40, 4: 2, 5: 40}[mode],)
    val, grads = jax.value_and_grad(model.log_joint)(params)
    assert np.isfinite(float(val))
    for g in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(g)).all()


def test_hmc_recovers_selfing_rates(panel):
    model = MarginalModel(ModelSpec(mode=2, n_pops=2), panel.data)
    params = model.init(jax.random.key(4))
    samples, acc, _ = run_hmc(
        model.potential, params, jax.random.key(5),
        HmcConfig(n_warmup=150, n_samples=150, n_leapfrog=12,
                  init_step=0.02),
        collect=lambda p: model.selfing_rates(p))
    s = np.sort(np.asarray(samples).mean(0))
    assert acc > 0.3, acc
    assert s[0] < 0.45 and s[1] > 0.55, s


def test_svi_recovers_selfing_rates(panel):
    model = MarginalModel(ModelSpec(mode=2, n_pops=2), panel.data)
    params = model.init(jax.random.key(6))
    mu, _, _ = run_svi(model.log_joint, params, jax.random.key(7),
                       SviConfig(n_steps=400, learning_rate=0.05))
    s = np.sort(np.asarray(jax.nn.sigmoid(mu.phi_s)))
    assert s[0] < 0.45 and s[1] > 0.55, s
