"""XLA Z-Gibbs + Q update (mcmc/updates.py:update_zq): count bookkeeping,
the per-copy conditional distribution, and shapes off any block grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.mcmc import updates as up


@pytest.fixture(scope="module")
def setup():
    panel = synthetic_panel(n_indv=17, n_loci=23, n_pops=3, n_alleles=2,
                            missing_rate=0.1, seed=5)
    data = panel.data
    rng = np.random.default_rng(0)
    freq = jnp.asarray(rng.dirichlet(np.ones(2), size=(3, 23)), jnp.float32)
    q = jnp.asarray(rng.dirichlet(np.ones(3), size=17), jnp.float32)
    return data, freq, q


def test_zq_update_counts_consistent(setup):
    data, freq, q = setup
    spec = ModelSpec(mode=1, n_pops=3)
    z, q_new, qqnum = up.update_zq(jax.random.key(1234), spec, data, freq,
                                   q, jnp.float32(1.0))
    assert z.shape == data.geno.shape
    assert ((np.asarray(z) >= 0) & (np.asarray(z) < 3)).all()
    # counts must equal the recount of z over valid sites
    valid = np.tile(np.asarray(data.site_valid), (1, 2))   # copy-major
    want = np.stack([(valid & (np.asarray(z) == k)).sum(1)
                     for k in range(3)], axis=1)
    np.testing.assert_allclose(np.asarray(qqnum), want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(q_new).sum(1), 1.0, atol=1e-5)


def test_zq_update_conditional_distribution(setup):
    data, freq, q = setup
    spec = ModelSpec(mode=1, n_pops=3)
    keys = jax.random.split(jax.random.key(0), 300)
    emp = np.asarray(jax.jit(jax.vmap(
        lambda kk: up.update_zq(kk, spec, data, freq, q,
                                jnp.float32(1.0))[0]))(keys))   # [T, N, S]
    geno3 = data.geno3
    n, l, p = geno3.shape
    f = np.asarray(freq)
    qn = np.asarray(q)
    l_idx = np.arange(l)[None, :, None]
    w = np.stack([qn[:, k][:, None, None] * f[k][l_idx, geno3]
                  for k in range(3)], axis=-1)     # [N, L, P, K]
    want = (w / w.sum(-1, keepdims=True)).transpose(0, 2, 1, 3).reshape(
        n, p * l, 3)
    for k in range(3):
        np.testing.assert_allclose((emp == k).mean(0), want[..., k],
                                   atol=0.12)


def test_zq_update_padding_edges():
    # shapes far from any power of two
    panel = synthetic_panel(n_indv=5, n_loci=7, n_pops=2, seed=8)
    data = panel.data
    rng = np.random.default_rng(1)
    freq = jnp.asarray(rng.dirichlet(np.ones(2), size=(2, 7)), jnp.float32)
    q = jnp.asarray(rng.dirichlet(np.ones(2), size=5), jnp.float32)
    spec = ModelSpec(mode=1, n_pops=2)
    z, _, qqnum = up.update_zq(jax.random.key(7), spec, data, freq, q,
                               jnp.float32(1.0))
    assert z.shape == (5, 14)
    valid = np.tile(np.asarray(data.site_valid), (1, 2))   # copy-major
    assert np.asarray(qqnum).sum() == valid.sum()
