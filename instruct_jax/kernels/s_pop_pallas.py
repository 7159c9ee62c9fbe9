"""Fused Pallas (Triton route) kernel for the mode-2 S-update tail.

The mode-2 selfing-rate update (update_S_POP, mcmc.c:913-983) is a
per-subpopulation MH sweep whose target couples the K pops through
sbar_i = sum_k q_ik s_k (proposal(), mcmc.c:1630-1648), so pops update one
at a time.  With `s_subsweeps` inner sweeps the XLA formulation is a chain
of J * K tiny dependent kernels (rank-1 sbar update + two O(N) reductions
each), bound by launch latency rather than by work.

This kernel runs the whole tail as one program per chain, all N in one
block:

  * all J * K back-reflection MH iterations, caching the scalar target
    f(sbar) = sum_i [ (g_i - 1) log sbar_i ]_{g_i > 1} + sum_i log(1 - sbar_i)
    so each iteration is one rank-1 update + one fresh evaluation;
  * the selfing-generation proposal g' ~ Geom(1 - sbar) at the fresh sbar
    with the boundary overrides of update_G (mcmc.c:1071-1084);
  * the generation-weight pair w = 2^{1-g} for (current, proposed) g that
    the fused site pass consumes; and
  * the log-uniforms for the downstream G accept,

with the counter-based hash of kernels/fused_step.py for its random bits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from instruct_jax.kernels.fused_step import _pow2, _seed_pair, mix32

_EPS = 1e-30
MAX_POPS = 8

# stream ids of the four draw families (proposal, accept, G proposal,
# G accept) in the counter hash
_S_PROP, _S_ACC, _S_GEN, _S_LOGU = 1, 2, 3, 4


def _u01(s0, s1, stream, idx):
    """U(0, 1) strictly inside the open interval (23-bit resolution) for
    the counter ``idx`` (i32 scalar or vector) of draw family ``stream``."""
    x = idx.astype(jnp.uint32) * jnp.uint32(8) + jnp.uint32(stream)
    bits = mix32(mix32(x ^ s0.astype(jnp.uint32)) + s1.astype(jnp.uint32))
    return ((bits >> 9).astype(jnp.int32).astype(jnp.float32) + 0.5) * (
        1.0 / (1 << 23))


def _log(x):
    return jnp.log(jnp.maximum(x, _EPS))


def _kernel(*refs, n_pops, subsweeps, delta0, gen_cap, np_, injected):
    if injected:
        (seed_ref, q_ref, g1_ref, rates_ref, up_ref, ua_ref, ug_ref, ul_ref,
         o_r, o_g, o_w, o_u) = refs
    else:
        seed_ref, q_ref, g1_ref, rates_ref, o_r, o_g, o_w, o_u = refs
    s0 = seed_ref[0]
    s1 = seed_ref[1]
    lane = jax.lax.broadcasted_iota(jnp.int32, (np_,), 0)

    def scalar_u(stream, idx):
        if injected:
            return (up_ref if stream == _S_PROP else ua_ref)[idx]
        return _u01(s0, s1, stream, jnp.int32(idx))

    g1 = g1_ref[:]                                   # (Np,) f32, pad = 0
    ghas = g1 > 0.0
    qrows = [q_ref[kk, :] for kk in range(n_pops)]
    rates = [rates_ref[kk] for kk in range(n_pops)]
    sbar = rates[0] * qrows[0]
    for kk in range(1, n_pops):
        sbar = sbar + rates[kk] * qrows[kk]

    def target(sb):
        # padded lanes: q rows are zero-padded so sb = 0 there ->
        # log(1 - 0) = 0 and g1 = 0 kills the first term: exact sum.
        t = jnp.where(ghas, g1 * _log(sb), 0.0) + _log(1.0 - sb)
        return t.sum()

    f_cur = target(sbar)
    for j in range(subsweeps):
        for kk in range(n_pops):
            idx = j * n_pops + kk
            u = scalar_u(_S_PROP, idx)
            s_old = rates[kk]
            s_step = jnp.abs(s_old + (2.0 * u - 1.0) * delta0)
            s_new = jnp.where(s_step >= 1.0, 2.0 - s_step, s_step)
            sbar_new = sbar + qrows[kk] * (s_new - s_old)
            f_new = target(sbar_new)
            acc = jnp.log(scalar_u(_S_ACC, idx)) < (f_new - f_cur)
            rates[kk] = jnp.where(acc, s_new, s_old)
            sbar = jnp.where(acc, sbar_new, sbar)
            f_cur = jnp.where(acc, f_new, f_cur)

    # g' ~ Geom(1 - sbar) on {1..cap} with update_G's boundary overrides
    ug = ug_ref[:] if injected else _u01(s0, s1, _S_GEN, lane)
    s_c = jnp.clip(sbar, 1e-6, 1.0 - 1e-6)
    g = 1 + jnp.floor(jnp.log(ug) / jnp.log(s_c)).astype(jnp.int32)
    g = jnp.clip(g, 1, gen_cap)
    g = jnp.where(sbar <= 1e-3, 1, g)
    g = jnp.where(sbar >= 1.0 - 1e-3, gen_cap, g)
    o_g[:] = g

    o_w[0, :] = jnp.exp2(1.0 - (g1 + 1.0))
    o_w[1, :] = jnp.exp2(1.0 - g.astype(jnp.float32))
    ul = ul_ref[:] if injected else _u01(s0, s1, _S_LOGU, lane)
    o_u[:] = jnp.log(ul)

    kl = jax.lax.broadcasted_iota(jnp.int32, (MAX_POPS,), 0)
    rvec = jnp.zeros((MAX_POPS,), jnp.float32)
    for kk in range(n_pops):
        rvec = jnp.where(kl == kk, rates[kk], rvec)
    o_r[:] = rvec


@functools.partial(jax.jit, static_argnames=("subsweeps", "delta0",
                                             "gen_cap", "interpret"))
def s_pop_tail(seed, q, gen, rates, *, subsweeps, delta0, gen_cap,
               interpret=False, test_draws=None):
    """Fused mode-2 S tail: J*K MH subsweeps + G proposal + accept logu.

    seed    i32[] or i32[W]   key words (fused_step.seed_words)
    q       f32[N, K]         admixture proportions
    gen     i32[N]            current selfing generations
    rates   f32[K]            current selfing rates

    Returns (rates' f32[K], gen_prop i32[N], wg_pair f32[N, 2],
    logu_acc f32[N]).  wg_pair is 2^{1-g} at (current, proposed) g — the
    column pair zq_gendiff_pass consumes; logu_acc the log-uniforms for
    the G MH accept.  `test_draws` feeds explicit uniforms in draw order
    (u_prop, u_acc [P] with P >= J*K; ug, u_logu [N]) in place of the
    hash, for tests and the on-card comparison.
    """
    n, k = q.shape
    if k > MAX_POPS:
        raise ValueError(f"s_pop_tail supports n_pops <= {MAX_POPS}, got {k}")
    sub = max(1, subsweeps)
    np_ = _pow2(max(n, 16))
    qp = jnp.pad(q.astype(jnp.float32).T, ((0, MAX_POPS - k), (0, np_ - n)))
    g1 = jnp.pad(gen.astype(jnp.float32) - 1.0, (0, np_ - n))
    rp = jnp.pad(rates.astype(jnp.float32), (0, MAX_POPS - k))
    operands = [_seed_pair(seed), qp, g1, rp]
    injected = test_draws is not None
    if injected:
        u_prop, u_acc, ug, ul = (jnp.asarray(d, jnp.float32).reshape(-1)
                                 for d in test_draws)
        p = _pow2(max(sub * k, 16))
        operands += [jnp.pad(u_prop[:p], (0, p - min(p, u_prop.shape[0]))),
                     jnp.pad(u_acc[:p], (0, p - min(p, u_acc.shape[0]))),
                     jnp.pad(ug[:n], (0, np_ - n), constant_values=0.5),
                     jnp.pad(ul[:n], (0, np_ - n), constant_values=0.5)]

    out_shapes = (jax.ShapeDtypeStruct((MAX_POPS,), jnp.float32),
                  jax.ShapeDtypeStruct((np_,), jnp.int32),
                  jax.ShapeDtypeStruct((2, np_), jnp.float32),
                  jax.ShapeDtypeStruct((np_,), jnp.float32))
    r_out, gprop, wg, logu = pl.pallas_call(
        functools.partial(_kernel, n_pops=k, subsweeps=sub, delta0=delta0,
                          gen_cap=gen_cap, np_=np_, injected=injected),
        grid=(1,), out_shape=out_shapes, backend="triton",
        interpret=interpret,
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        name="s_pop_tail",
    )(*operands)
    return (r_out[:k], gprop[:n], wg[:, :n].T, logu[:n])


def s_pop_tail_reference(q, gen, rates, draws, *, subsweeps, delta0,
                         gen_cap):
    """The kernel's arithmetic as plain jnp (XLA), consuming ``draws`` in
    the kernel's order — the reference the on-card comparison runs."""
    u_prop, u_acc, ug, ul = (jnp.asarray(d, jnp.float32).reshape(-1)
                             for d in draws)
    n, k = q.shape
    g1 = gen.astype(jnp.float32) - 1.0
    rates = [rates[kk].astype(jnp.float32) for kk in range(k)]
    qrows = [q[:, kk].astype(jnp.float32) for kk in range(k)]
    sbar = rates[0] * qrows[0]
    for kk in range(1, k):
        sbar = sbar + rates[kk] * qrows[kk]

    def target(sb):
        return (jnp.where(g1 > 0, g1 * _log(sb), 0.0)
                + _log(1.0 - sb)).sum()

    f_cur = target(sbar)
    for j in range(max(1, subsweeps)):
        for kk in range(k):
            idx = j * k + kk
            s_step = jnp.abs(rates[kk] + (2.0 * u_prop[idx] - 1.0) * delta0)
            s_new = jnp.where(s_step >= 1.0, 2.0 - s_step, s_step)
            sbar_new = sbar + qrows[kk] * (s_new - rates[kk])
            f_new = target(sbar_new)
            acc = jnp.log(u_acc[idx]) < f_new - f_cur
            rates[kk] = jnp.where(acc, s_new, rates[kk])
            sbar = jnp.where(acc, sbar_new, sbar)
            f_cur = jnp.where(acc, f_new, f_cur)
    s_c = jnp.clip(sbar, 1e-6, 1.0 - 1e-6)
    g = 1 + jnp.floor(jnp.log(ug[:n]) / jnp.log(s_c)).astype(jnp.int32)
    g = jnp.clip(g, 1, gen_cap)
    g = jnp.where(sbar <= 1e-3, 1, g)
    g = jnp.where(sbar >= 1.0 - 1e-3, gen_cap, g)
    wg = jnp.stack([jnp.exp2(1.0 - gen.astype(jnp.float32)),
                    jnp.exp2(1.0 - g.astype(jnp.float32))], axis=1)
    return jnp.stack(rates), g, wg, jnp.log(ul[:n])
