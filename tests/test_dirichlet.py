"""Dirichlet draws of the P and Q updates (mcmc/updates.py:
dirichlet_from_counts): moments against the exact Dirichlet, the simplex,
and the padding mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.mcmc import updates as up


@pytest.mark.parametrize("scale", [40.0, 0.4])
def test_moments_match_exact_dirichlet(scale):
    """Mean and variance of each coordinate against the closed forms
    a_i / a0 and a_i (a0 - a_i) / (a0^2 (a0 + 1)), at large and at small
    concentration (the small one exercises the a < 1 boost)."""
    conc = jnp.asarray([1.0, 2.0, 5.0]) * scale
    draws = np.asarray(jax.jit(jax.vmap(
        lambda kk: up.dirichlet_from_counts(kk, conc)))(
            jax.random.split(jax.random.key(3), 20000)))
    a = np.asarray(conc)
    a0 = a.sum()
    mean = a / a0
    var = a * (a0 - a) / (a0 ** 2 * (a0 + 1.0))
    se = np.sqrt(var / draws.shape[0])
    np.testing.assert_array_less(np.abs(draws.mean(0) - mean), 5 * se)
    np.testing.assert_allclose(draws.var(0), var, rtol=0.1)


def test_group_simplex_and_mask():
    rng = np.random.default_rng(3)
    conc = jnp.asarray(rng.uniform(0.5, 9.0, (130, 4)), jnp.float32)
    valid = jnp.asarray(rng.random((130, 4)) > 0.3).at[:, 0].set(True)
    out = np.asarray(up.dirichlet_from_counts(jax.random.key(1), conc,
                                              valid))
    v = np.asarray(valid)
    assert (out[~v] == 0).all()
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


def test_dirichlet_kla_shape_roundtrip():
    """The P update's [K, L, A] draw from counts + 1 with the per-locus
    allele mask: every (pop, locus) row is a distribution over the valid
    alleles only."""
    rng = np.random.default_rng(5)
    k, l, a = 3, 40, 4
    counts = jnp.asarray(rng.integers(0, 30, (k, l, a)), jnp.float32)
    n_alleles = rng.integers(2, a + 1, l)
    valid = jnp.asarray(np.arange(a)[None, :] < n_alleles[:, None])
    freq = np.asarray(up.dirichlet_from_counts(jax.random.key(2),
                                               counts + 1.0, valid[None]))
    assert freq.shape == (k, l, a)
    np.testing.assert_allclose(freq.sum(-1), 1.0, atol=1e-5)
    assert (freq[:, ~np.asarray(valid)] == 0).all()
