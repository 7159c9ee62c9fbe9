"""Unit tests for the Gibbs/MH update kernels: conditional-distribution
checks against closed forms (survey §4 test-pyramid item 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.mcmc import updates as up
from instruct_jax.mcmc.state import masked_z_counts


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(n_indv=20, n_loci=15, n_pops=2, n_alleles=3,
                           missing_rate=0.15, seed=7)


def test_allele_pop_counts_bruteforce(panel):
    data = panel.data
    spec = ModelSpec(mode=2, n_pops=2)
    rng = np.random.default_rng(0)
    n, l, p = data.geno3.shape
    z = rng.integers(0, 2, size=(n, l, p))
    got = np.asarray(up.allele_pop_counts(
        spec, data, jnp.asarray(z.transpose(0, 2, 1).reshape(n, p * l)), None))

    geno = data.geno3
    valid = np.asarray(data.site_valid)
    want = np.zeros_like(got)
    for i in range(n):
        for j in range(l):
            if not valid[i, j]:
                continue
            for c in range(p):
                want[z[i, j, c], j, geno[i, j, c]] += 1
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_update_freq_posterior_mean(panel):
    # P | Z ~ Dir(counts + 1): with many draws the empirical mean must equal
    # (counts + 1) / sum(counts + 1) over valid alleles.
    data = panel.data
    spec = ModelSpec(mode=2, n_pops=2)
    rng = np.random.default_rng(1)
    n, l, p = data.geno3.shape
    z = jnp.asarray(rng.integers(0, 2, size=(n, l * p)))
    counts = np.asarray(up.allele_pop_counts(spec, data, z, None))
    draws = jax.vmap(
        lambda k: up.update_freq(k, spec, data, z, None)
    )(jax.random.split(jax.random.key(0), 400))
    emp = np.asarray(draws).mean(0)
    valid = np.asarray(data.allele_valid)
    conc = (counts + 1.0) * valid[None]
    want = conc / conc.sum(-1, keepdims=True)
    np.testing.assert_allclose(emp[:, valid.all(0).nonzero()[0]],
                               want[:, valid.all(0).nonzero()[0]],
                               atol=0.03)


def test_update_zq_conditional(panel):
    # z[n,l,c] ~ Cat(q[n,:] * freq[:, l, a]); check empirical frequencies.
    data = panel.data
    spec = ModelSpec(mode=2, n_pops=2)
    rng = np.random.default_rng(2)
    n, l, p = data.geno3.shape
    freq = jnp.asarray(rng.dirichlet(np.ones(3), size=(2, l)), jnp.float32)
    q = jnp.asarray(rng.dirichlet(np.ones(2), size=n), jnp.float32)
    alpha = jnp.float32(1.0)
    zs = jax.vmap(
        lambda k: up.update_zq(k, spec, data, freq, q, alpha)[0]
    )(jax.random.split(jax.random.key(1), 300))
    emp_p1 = (np.asarray(zs == 1).mean(0).reshape(n, p, l)
              .transpose(0, 2, 1))
    geno = data.geno3
    f = np.asarray(freq)
    qn = np.asarray(q)
    l_idx = np.arange(l)[None, :, None]
    p0 = f[0][l_idx, geno] * qn[:, 0][:, None, None]
    p1 = f[1][l_idx, geno] * qn[:, 1][:, None, None]
    want = p1 / (p0 + p1)
    np.testing.assert_allclose(emp_p1, want, atol=0.12)


def test_masked_z_counts(panel):
    data = panel.data
    rng = np.random.default_rng(3)
    n, l, p = data.geno3.shape
    z = rng.integers(0, 2, size=(n, l, p))
    got = np.asarray(masked_z_counts(jnp.asarray(z.transpose(0, 2, 1).reshape(n, p * l)),
                                     data, 2))
    valid = np.asarray(data.site_valid)
    want = np.zeros((n, 2))
    for i in range(n):
        for j in range(l):
            if valid[i, j]:
                for c in range(p):
                    want[i, z[i, j, c]] += 1
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_back_reflection_bounds():
    key = jax.random.key(0)
    x = jnp.linspace(0.0, 1.0, 101)
    prop = up.propose_back_reflection(key, x, 0.05)
    assert float(prop.min()) >= 0.0
    assert float(prop.max()) <= 1.0


def test_adaptive_independence_stationary():
    # The 3-state chain kernel (mcmc.c:1461-1519) over states {0,1,2}.
    key = jax.random.key(5)
    state = jnp.zeros(2000, jnp.int32) + 1
    rates = jnp.full(2000, 0.5)
    new_r, new_s, lh = up.propose_adaptive_independence(key, rates, state)
    frac0 = float((new_s == 0).mean())
    frac2 = float((new_s == 2).mean())
    assert 0.02 < frac0 < 0.08 and 0.02 < frac2 < 0.08
    assert np.isfinite(np.asarray(lh)).all()
    # boundary values delivered exactly
    assert float(jnp.abs(jnp.where(new_s == 0, new_r, 0)).max()) == 0.0


def test_sample_geometric_distribution():
    key = jax.random.key(9)
    sbar = jnp.full(20000, 0.6)
    g = np.asarray(up.sample_geometric(key, sbar, 50))
    assert g.min() >= 1 and g.max() <= 50
    # P(g=1) = 1 - sbar = 0.4
    assert abs((g == 1).mean() - 0.4) < 0.02
    # E[g] = 1/(1-sbar) = 2.5
    assert abs(g.mean() - 2.5) < 0.1


def test_update_alpha_moves_and_respects_positivity():
    spec = ModelSpec(mode=2, n_pops=3)
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.dirichlet(np.ones(3) * 5, size=50), jnp.float32)
    alpha = jnp.float32(2.0)
    vals = []
    key = jax.random.key(2)
    for i in range(200):
        alpha = up.update_alpha(jax.random.fold_in(key, i), spec, q, alpha)
        vals.append(float(alpha))
    vals = np.array(vals)
    assert (vals > 0).all()
    assert vals.std() > 0.01  # it moves


def test_empty_cluster_flag():
    # Threshold is on the summed occupancy over individuals (< 0.01,
    # mcmc.c:1966).
    q = jnp.asarray([[0.9999, 0.0001]] * 30)
    assert bool(up.empty_cluster_flag(q))
    q = jnp.asarray([[0.7, 0.3]] * 30)
    assert not bool(up.empty_cluster_flag(q))
