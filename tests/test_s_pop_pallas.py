"""Fused mode-2 S tail kernel (kernels/s_pop_pallas.py): exact numpy
replica given the same uniform draws (interpret mode), and composition
with the fused step — statistical agreement of the S posterior between
the fused tail and the XLA S-subsweep path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.kernels.s_pop_pallas import s_pop_tail


def np_replica(q, gen, rates, draws, *, subsweeps, delta0, gen_cap):
    """The kernel's exact math in numpy, consuming `draws` in order."""
    u_prop, u_acc, ug, ul = [np.asarray(d, np.float32) for d in draws]
    n, k = q.shape
    g1 = (gen.astype(np.float32) - 1.0)
    rates = rates.astype(np.float32).copy()
    sbar = (q @ rates).astype(np.float32)

    def target(sb):
        t = (np.where(g1 > 0, g1 * np.log(np.maximum(sb, 1e-30)), 0.0)
             + np.log(np.maximum(1.0 - sb, 1e-30)))
        return np.float32(t.astype(np.float32).sum())

    f_cur = target(sbar)
    for j in range(subsweeps):
        for kk in range(k):
            idx = j * k + kk
            u = u_prop[idx // 128, idx % 128]
            s_step = abs(rates[kk] + (2.0 * u - 1.0) * delta0)
            s_new = 2.0 - s_step if s_step >= 1.0 else s_step
            sbar_new = sbar + q[:, kk] * np.float32(s_new - rates[kk])
            f_new = target(sbar_new)
            if np.log(u_acc[idx // 128, idx % 128]) < f_new - f_cur:
                rates[kk] = s_new
                sbar, f_cur = sbar_new, f_new

    ugr = ug[0, :n]
    s_c = np.clip(sbar, 1e-6, 1.0 - 1e-6)
    g = 1 + np.floor(np.log(ugr) / np.log(s_c)).astype(np.int32)
    g = np.clip(g, 1, gen_cap)
    g = np.where(sbar <= 1e-3, 1, g)
    g = np.where(sbar >= 1.0 - 1e-3, gen_cap, g)
    wg = np.stack([np.exp2(1.0 - gen.astype(np.float32)),
                   np.exp2(1.0 - g.astype(np.float32))], axis=1)
    return rates, g, wg, np.log(ul[0, :n])


@pytest.mark.parametrize("n,k,subsweeps", [(70, 3, 4), (130, 2, 1)])
def test_matches_numpy_replica(n, k, subsweeps):
    rng = np.random.default_rng(5)
    q = rng.dirichlet(np.full(k, 0.4), size=n).astype(np.float32)
    gen = rng.integers(1, 9, n).astype(np.int32)
    rates = rng.uniform(0.05, 0.95, k).astype(np.float32)
    urows = -(-subsweeps * k // 128)
    np_ = n + (-n % 128)
    draws = [
        jnp.asarray(rng.uniform(1e-4, 1 - 1e-4, (urows, 128)), jnp.float32),
        jnp.asarray(rng.uniform(1e-4, 1 - 1e-4, (urows, 128)), jnp.float32),
        jnp.asarray(rng.uniform(1e-4, 1 - 1e-4, (1, np_)), jnp.float32),
        jnp.asarray(rng.uniform(1e-4, 1 - 1e-4, (1, np_)), jnp.float32),
    ]
    out = s_pop_tail(jnp.zeros(2, jnp.int32), jnp.asarray(q),
                     jnp.asarray(gen), jnp.asarray(rates),
                     subsweeps=subsweeps, delta0=0.05, gen_cap=50,
                     interpret=True, test_draws=draws)
    ref = np_replica(q, gen, rates, draws, subsweeps=subsweeps,
                     delta0=0.05, gen_cap=50)
    np.testing.assert_allclose(np.asarray(out[0]), ref[0], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out[1]), ref[1])
    np.testing.assert_allclose(np.asarray(out[2]), ref[2], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out[3]), ref[3], rtol=1e-5)


def test_boundary_overrides():
    """sbar ~ 0 -> g = 1; sbar ~ 1 -> g = cap (update_G, mcmc.c:1071-1084)."""
    n, k = 8, 2
    q = np.zeros((n, k), np.float32)
    q[:4, 0] = 1.0   # sbar = rates[0] ~ 0
    q[4:, 1] = 1.0   # sbar = rates[1] ~ 1
    gen = np.ones(n, np.int32)
    rates = np.array([1e-6, 1.0 - 1e-6], np.float32)
    half = jnp.full((1, 128), 0.5, jnp.float32)
    draws = [half, half, jnp.full((1, 128), 0.5, jnp.float32),
             jnp.full((1, 128), 0.5, jnp.float32)]
    out = s_pop_tail(jnp.zeros(2, jnp.int32), jnp.asarray(q),
                     jnp.asarray(gen), jnp.asarray(rates),
                     subsweeps=0, delta0=0.0, gen_cap=50, interpret=True,
                     test_draws=draws)
    gprop = np.asarray(out[1])
    # subsweeps=0 still runs one sweep with delta0=0 (proposal == current,
    # always accepted: log-ratio 0 > log u), so rates stay put
    np.testing.assert_allclose(np.asarray(out[0]), rates, atol=1e-6)
    assert (gprop[:4] == 1).all()
    assert (gprop[4:] == 50).all()


def test_rejects_wide_k():
    q = jnp.ones((4, 9), jnp.float32) / 9
    with pytest.raises(ValueError):
        s_pop_tail(jnp.zeros(2, jnp.int32), q, jnp.ones(4, jnp.int32),
                   jnp.full((9,), 0.5), subsweeps=1, delta0=0.05,
                   gen_cap=50, interpret=True)
