"""On-device streaming posterior-moment accumulators.

The reference stores running means and running means-of-squares of every
tracked quantity with the incremental form
    m_{n+1} = m_n * ((n + x/m_n) / (n+1))
(store_chn, mcmc.c:1320-1456).  That form is just Welford's mean update in
disguise (and divides by zero if a draw is exactly the current mean of 0); we
use the standard stable update  m += w (x - m) / n  which keeps f32 accurate
over millions of samples, so no f64 is needed on the device.

Tracked slots mirror CHAIN (allocate_chn, mcmc.c:588-642): total log-lik,
per-individual log-lik, Q (or mode-0 membership one-hot), S/F, G, and
optionally P.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.dataset import Dataset
from instruct_jax.mcmc.state import McmcState


class TrackedStats(NamedTuple):
    """One sample of everything store_chn records."""

    total_ll: jnp.ndarray   # f32[]
    indv_ll: jnp.ndarray    # f32[N]
    q: jnp.ndarray          # f32[N, K] (mode 0: one-hot of zz)
    rates: jnp.ndarray      # f32[R]
    gen: jnp.ndarray        # f32[N] or f32[0]
    freq: jnp.ndarray       # f32[K, L, A] or f32[0]
    ll_marg: jnp.ndarray    # f32[N] pointwise per-individual log-lik
    #   (refreshed every Schedule.dic_every-th stored step and held
    #   constant between refreshes — repeats weight the subsample
    #   uniformly, so every statistic below is an unbiased subsampled
    #   estimate).  mean -> the E[logL] term of the corrected DIC;
    #   mean/mean_sq -> the per-individual Var[logL_i] of WAIC's pwaic.
    #   Focus (documented model-choice choice): diploid modes use the
    #   Z-MARGINALIZED likelihood (likelihood.py:marginal_site_loglik);
    #   the tetraploid engine has no closed marginal over its latent
    #   ordering, so its focus is the (z, geno)-CONDITIONAL pointwise
    #   likelihood (tetra/engine.py:_site_loglik summed per individual) —
    #   each draw conditions on that draw's latents, the standard
    #   conditional-focus WAIC for latent-variable models.
    freq2: jnp.ndarray = None  # f32[K, L, A] second frequency system
    #   (allotetraploid with track_freq; size 0 otherwise) — needed so the
    #   tetra plug-in deviance can evaluate at the posterior means


class ChainAccum(NamedTuple):
    """Streaming moments plus convergence trace for one chain."""

    count: jnp.ndarray        # i32[] — number of stored samples so far
    mean: TrackedStats
    mean_sq: TrackedStats
    convg_ld: jnp.ndarray     # f32[ckrep] — first ckrep stored total log-liks
    #   (the cvg->convg_ld buffer, check_converg.c:24-33, filled at
    #   mcmc.c:223-225)
    empty_cluster: jnp.ndarray  # bool[] — latched at the
    #   nstep_check_empty_cluster-th stored sample (mcmc.c:227-234)
    lme_indv: jnp.ndarray     # f32[N] running log-mean-exp of the
    #   per-individual pointwise log-lik: log E[p(y_i | theta)], the
    #   lppd term of WAIC (Watanabe 2010).  Label-invariant, unlike the
    #   DIC plug-in — the statistic K-selection uses (kselect.py).
    m2_ll_marg: jnp.ndarray   # f32[N] Welford sum of squared deviations of
    #   the per-individual marginal log-lik — Var[log p(y_i|theta)] =
    #   m2/count is WAIC's pwaic_2 term.  A separate centered accumulator
    #   because E[x^2]-E[x]^2 in f32 cancels catastrophically at
    #   |logL_i| ~ 1e3.


def extract_stats(spec: ModelSpec, state: McmcState, track_freq: bool
                  ) -> TrackedStats:
    if spec.mode == 0 and spec.ploid == 2:
        q = jax.nn.one_hot(state.zz, spec.n_pops, dtype=jnp.float32)
    else:
        q = state.q
    gen = (state.gen.astype(jnp.float32) if spec.has_selfing
           else jnp.zeros((0,), jnp.float32))
    freq = state.freq if track_freq else jnp.zeros((0,), jnp.float32)
    freq2 = (state.freq2 if (track_freq and spec.ploid == 4
                             and not spec.autopoly)
             else jnp.zeros((0,), jnp.float32))
    ll_marg = (state.loglik_marg if state.loglik_marg is not None
               else jnp.zeros((0,), jnp.float32))
    return TrackedStats(
        total_ll=state.loglik_total,
        indv_ll=state.loglik_indv,
        q=q,
        rates=state.rates,
        gen=gen,
        freq=freq,
        ll_marg=ll_marg,
        freq2=freq2,
    )


def init_accum(spec: ModelSpec, sched: Schedule, data: Dataset,
               track_freq: bool) -> ChainAccum:
    n = data.n_indv
    k = spec.n_pops
    a = data.max_alleles
    l = data.n_loci
    r = spec.n_rates(n)
    allo = spec.ploid == 4 and not spec.autopoly
    zeros = TrackedStats(
        total_ll=jnp.zeros(()),
        indv_ll=jnp.zeros((n,)),
        q=jnp.zeros((n, k)),
        rates=jnp.zeros((r,)),
        gen=jnp.zeros((n,) if spec.has_selfing else (0,)),
        freq=jnp.zeros((k, l, a) if track_freq else (0,)),
        ll_marg=jnp.zeros((n,)),
        freq2=jnp.zeros((k, l, a) if (track_freq and allo) else (0,)),
    )
    return ChainAccum(
        count=jnp.zeros((), jnp.int32),
        mean=zeros,
        mean_sq=zeros,
        convg_ld=jnp.zeros((sched.ckrep,)),
        empty_cluster=jnp.asarray(False),
        lme_indv=jnp.full((n,), -jnp.inf),
        m2_ll_marg=jnp.zeros((n,)),
    )


def accum_update(accum: ChainAccum, stats: TrackedStats, store: jnp.ndarray,
                 empty_flag: jnp.ndarray, check_at: int) -> ChainAccum:
    """Fold one MCMC draw into the moments with weight ``store`` in {0,1}.

    ``empty_flag`` is the instantaneous empty-cluster indicator; it is
    latched exactly when the stored count reaches ``check_at`` — matching
    `if(cnt_step==nstep_check_empty_cluster)` in every mode loop
    (e.g. mcmc.c:227-234).
    """
    w = store.astype(jnp.float32)
    new_count = accum.count + store.astype(jnp.int32)
    denom = jnp.maximum(new_count.astype(jnp.float32), 1.0)

    def upd(m, x):
        return m + w * (x - m) / denom

    def upd_sq(m, x):
        return m + w * (x * x - m) / denom

    mean = jax.tree.map(upd, accum.mean, stats)
    mean_sq = jax.tree.map(upd_sq, accum.mean_sq, stats)

    ckrep = accum.convg_ld.shape[0]
    write = (store > 0) & (accum.count < ckrep)
    # masked vector write, not a scatter: a batched dynamic-index scatter
    # inside the scan is a serial update per chain
    hit = (jnp.arange(ckrep) == accum.count) & write
    convg = jnp.where(hit, stats.total_ll, accum.convg_ld)

    latch = (new_count == check_at) & (accum.count != new_count)
    empty = accum.empty_cluster | (latch & empty_flag)

    # running log-mean-exp of exp(ll_marg_i): lme_{n+1} =
    # logaddexp(lme_n + log n, x) - log(n+1) — WAIC's lppd term, updated
    # with the same store weight as the moments (stable: ll values stay in
    # log space throughout)
    prev = jnp.where(accum.count > 0,
                     accum.lme_indv + jnp.log(
                         jnp.maximum(accum.count.astype(jnp.float32), 1.0)),
                     -jnp.inf)
    lme_new = (jnp.logaddexp(prev, stats.ll_marg)
               - jnp.log(denom))
    lme = jnp.where(store > 0, lme_new, accum.lme_indv)

    # Welford M2 for the marginal log-lik (old mean BEFORE this draw, new
    # mean after): m2 += w (x - m_old)(x - m_new)
    m2 = accum.m2_ll_marg + w * ((stats.ll_marg - accum.mean.ll_marg)
                                 * (stats.ll_marg - mean.ll_marg))

    return ChainAccum(count=new_count, mean=mean, mean_sq=mean_sq,
                      convg_ld=convg, empty_cluster=empty, lme_indv=lme,
                      m2_ll_marg=m2)


def variance(accum: ChainAccum) -> TrackedStats:
    """Posterior variance = E[x^2] - E[x]^2, the same estimator the report
    writer prints (e.g. result_analysis.c:90, 109)."""
    return jax.tree.map(lambda m2, m: m2 - m * m, accum.mean_sq, accum.mean)
