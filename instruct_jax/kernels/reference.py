"""Plain XLA references for the fused kernels, for the on-card comparison.

Each function evaluates what a kernel computes, in the straightforward
per-site form of the XLA update path (mcmc/updates.py, model/likelihood.py),
and where the kernel sums over loci also returns the L1 mass of the summed
terms: a float32 sum taken in another order can differ by a few ulps of
that mass, which is the scale the comparison's absolute tolerance takes.
"""

from __future__ import annotations

import jax.numpy as jnp

from instruct_jax.data.dataset import Dataset
from instruct_jax.model import likelihood as lk

_EPS = 1e-30
_LOG2 = 0.6931471805599453


def _log(x):
    return jnp.log(jnp.maximum(x, _EPS))


def z_draw(u, q, freq, data: Dataset):
    """The inverse-CDF z draw of update_zq (mcmc.c:1146) at uniforms u
    f32[N, S], and the distance of each u from its nearest CDF boundary
    (as a fraction of the total), which decides whether a disagreement
    between two summation orders is a near-tie."""
    k = freq.shape[0]
    terms = [q[:, kk][:, None] * pk
             for kk, pk in enumerate(lk.per_pop_copy_probs(freq, data))]
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    uu = u * total
    z = jnp.zeros(u.shape, jnp.int32)
    cum = jnp.zeros_like(total)
    gap = jnp.ones_like(total)
    for kk in range(k - 1):
        cum = cum + terms[kk]
        z = z + (uu > cum).astype(jnp.int32)
        gap = jnp.minimum(gap, jnp.abs(u - cum / jnp.maximum(total, _EPS)))
    return z, gap


def _copies_at_z(freq, data, z):
    p = lk.gather_freq_at_z(freq, data, z)
    p0, p1 = lk.split_copies(p, 2)
    z0, z1 = lk.split_copies(z, 2)
    return p0, p1, (z0 == z1)


def gendiff(freq, data: Dataset, z, wg_pair):
    """Structure-way G MH log-ratio per individual at z (update_G,
    mcmc.c:1053-1091): sum over valid same-z sites of
    log gf(g_prop) - log gf(g_cur).  Returns (value f32[N], l1 f32[N]) with
    l1 the mass of both log terms, the scale of their rounding."""
    p0, p1, same = _copies_at_z(freq, data, z)
    wc, wp = wg_pair[:, 0:1], wg_pair[:, 1:2]

    def log_gf(w):
        return _log(jnp.where(data.hom, p0 * p0 + p0 * (1.0 - p0) * (1.0 - w),
                              2.0 * p0 * p1 * w))

    m = same & data.site_valid
    lp, lc = log_gf(wp), log_gf(wc)
    t = jnp.where(m, lp - lc, 0.0)
    return t.sum(axis=1), jnp.where(m, jnp.abs(lp) + jnp.abs(lc),
                                    0.0).sum(axis=1)


def panel_loglik(freq, data: Dataset, z, wg):
    """Structure-way cal_lkh per individual (mcmc.c:1916-1942) at z with
    wg f32[N, 1] = 2^{1-g}.  Returns (value f32[N], l1 f32[N])."""
    p0, p1, same = _copies_at_z(freq, data, z)
    gf = jnp.where(data.hom, p0 * p0 + p0 * (1.0 - p0) * (1.0 - wg),
                   2.0 * p0 * p1 * wg)
    indep = _log(p0) + _log(p1) + jnp.where(data.hom, 0.0, _LOG2)
    t = jnp.where(data.site_valid, jnp.where(same, _log(gf), indep), 0.0)
    return t.sum(axis=1), jnp.abs(t).sum(axis=1)
