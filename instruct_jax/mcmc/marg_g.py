"""Rao-Blackwellized selfing-generation updates (``ModelSpec.marginalize_g``).

The reference treats the per-individual selfing-generation counts G as a
latent variable updated by MH (update_G, mcmc.c:1053-1091) and lets the
selfing rates S see the data only through G's geometric prior
(update_S_POP / update_S_IND target = proposal(), mcmc.c:1630-1648).
With ``marginalize_g=True`` the framework instead works with the
per-individual log-likelihood CURVE over g = 1..gen_cap:

  * G becomes an EXACT categorical Gibbs draw from its full conditional
    (truncated geometric prior x genotype likelihood) — zero MH rejection;
  * S (mode 2 per pop, mode 3 per individual) targets the G-MARGINAL
    posterior  sum_i logsumexp_g [ log Geom_trunc(g | sbar_i) + ll_i(g) ],
    so the S chain mixes as if G were integrated out.

The curve is affordable because it factorizes through the (pop, allele)
one-hot exactly like the DPM F-grid (mcmc/dpm.py:f_loglik_grid): with
w_g = 2^{1-g}, a hom same-z site contributes log p0 + log(1 - (1-p0) w_g)
(genofreq's telescoped closed form, mcmc.c:1683-1703), and
p0 = freq[z0, l, x0], so

    sum_l hommask[n,l] log(1 - (1-p0) w_g)  =  sum_{k,a} M_ka[n,:] @ T_ka[:,g]

— K*A masked [N, L] @ [L, G] matmuls.  Het same-z sites add the
separable n_het * (1-g) log 2; z-mismatch / invalid sites are
g-independent and drop out of every ratio.

Requires the structure-way genotype formulation (``type_freq == 1``, the
default): the expectation way replaces p0 by the continuous Q-mixture,
which does not factorize through the one-hot.

The truncation at gen_cap is treated exactly (normalized truncated
geometric) rather than by the reference's clip-the-sample cap
(mcmc.c:1076), a documented divergence that only matters as sbar -> 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from instruct_jax.config import ModelSpec
from instruct_jax.data.dataset import Dataset
from instruct_jax.mcmc import updates as up
from instruct_jax.model import likelihood as lk

# f32 products feeding MH ratios / log-likelihoods: never TF32
_HI = jax.lax.Precision.HIGHEST

_EPS = 1e-30
_LOG2 = 0.6931471805599453


def _slog(x):
    return jnp.log(jnp.maximum(x, _EPS))


def selfing_gtable(data: Dataset, freq, z, gen_cap: int,
                   axis_name=None) -> jnp.ndarray:
    """gtable f32[N, gen_cap]: the g-dependent part of each individual's
    log-likelihood at g = 1..gen_cap (relative — the g-independent site
    terms are omitted; only differences/logsumexps over g are ever used).
    psummed over loci shards when ``axis_name`` is set."""
    z0, z1 = lk.split_copies(z, data.ploid)
    x0, _ = lk.split_copies(data.geno, data.ploid)
    same = (z0 == z1) & data.site_valid
    hom_mask = same & data.hom
    n_het = (same & ~data.hom).sum(axis=1).astype(jnp.float32)   # [N]
    gens = jnp.arange(1, gen_cap + 1, dtype=jnp.float32)
    w = jnp.exp2(1.0 - gens)                                     # [G]
    k_pops, _, a_max = freq.shape
    n = z0.shape[0]
    gtable = n_het[:, None] * (1.0 - gens)[None, :] * _LOG2      # [N, G]
    for k in range(k_pops):
        zm = hom_mask & (z0 == k)
        for a in range(a_max):
            mask = (zm & (x0 == a)).astype(jnp.float32)          # [N, L]
            fk = freq[k, :, a][:, None]                          # [L, 1]
            t_tab = _slog(1.0 - (1.0 - fk) * w[None, :])         # [L, G]
            gtable = gtable + jax.lax.dot(
                mask, t_tab, precision=jax.lax.Precision.HIGHEST)
    return up._psum(gtable, axis_name)


def log_geom_trunc(sbar, gen_cap: int) -> jnp.ndarray:
    """Normalized truncated-geometric log-pmf rows f32[..., gen_cap] over
    g = 1..gen_cap given success-complement sbar (the conditional prior of
    update_G, mcmc.c:1063-1069, made exact under the cap)."""
    s = jnp.clip(sbar, 1e-7, 1.0 - 1e-7)[..., None]
    gens = jnp.arange(1, gen_cap + 1, dtype=jnp.float32)
    logs = jnp.log(s)
    # log(1 - s^cap) = log(-expm1(cap log s)), stable for s -> 1
    log_norm = jnp.log(-jnp.expm1(gen_cap * logs))
    return (gens - 1.0) * logs + jnp.log1p(-s) - log_norm


def sample_gen_marginal(key, gtable, sbar, gen_cap: int) -> jnp.ndarray:
    """Exact Gibbs draw of G from its full conditional — replaces the MH
    sweep (update_G, mcmc.c:1053-1091) with a categorical over the curve."""
    logits = gtable + log_geom_trunc(sbar, gen_cap)
    return (1 + jax.random.categorical(key, logits, axis=-1)).astype(
        jnp.int32)


def _marginal_loglik(gtable, sbar, gen_cap: int):
    """[N] per-individual log p(data_i | sbar_i) with G summed out (up to
    the shared g-independent constant)."""
    return jax.nn.logsumexp(gtable + log_geom_trunc(sbar, gen_cap), axis=-1)


def update_s_pop_marginal(key, spec: ModelSpec, q, gtable, rates,
                          ais_state):
    """Mode-2 S update targeting the G-marginal posterior.  Same
    Metropolis-within-Gibbs structure as update_s_pop (one pop at a time,
    rank-1 sbar update, back-reflection or adaptive-independence
    proposal), but the target sums G out of the likelihood — O(N * gen_cap)
    per pop evaluation instead of the G-prior-only surrogate."""
    k = spec.n_pops
    # split-derived accept keys + a disjoint proposal key: fold_in(key, j)
    # aliases split(key, k)[j], so K >= 18 would correlate pop 17's accept
    # with the proposals (ADVICE r4; same fix as updates.update_s_pop)
    kacc, kprop = jax.random.split(key)
    keys = jax.random.split(kacc, k)
    if spec.back_refl == 1:
        proposals = up.propose_back_reflection(kprop, rates, spec.mh_step_s)
        prop_states = ais_state
        log_hast = jnp.zeros((k,))
    else:
        proposals, prop_states, log_hast = \
            up.propose_adaptive_independence(kprop, rates, ais_state)

    def body(carry, j):
        rates_c, states_c, sbar, lml = carry
        s_new = proposals[j]
        sbar_new = sbar + q[:, j] * (s_new - rates_c[j])
        lml_new = _marginal_loglik(gtable, sbar_new, spec.gen_cap)
        log_ratio = (lml_new - lml).sum() + log_hast[j]
        u = jax.random.uniform(keys[j], minval=_EPS)
        accept = jnp.log(u) < log_ratio
        rates_c = rates_c.at[j].set(jnp.where(accept, s_new, rates_c[j]))
        states_c = states_c.at[j].set(
            jnp.where(accept, prop_states[j], states_c[j]))
        sbar = jnp.where(accept, sbar_new, sbar)
        lml = jnp.where(accept, lml_new, lml)
        return (rates_c, states_c, sbar, lml), None

    sbar0 = jnp.dot(q, rates, precision=_HI)
    lml0 = _marginal_loglik(gtable, sbar0, spec.gen_cap)
    (rates, ais_state, _, _), _ = jax.lax.scan(
        body, (rates, ais_state, sbar0, lml0), jnp.arange(k))
    return rates, ais_state


def update_s_ind_marginal(key, spec: ModelSpec, gtable, rates,
                          prior_mu=None, prior_sigma2=None):
    """Mode-3 per-individual S update on the G-marginal target (uniform or
    normal prior); individuals are independent so all N MH moves run in
    parallel."""
    kp, ku = jax.random.split(key)
    prop = up.propose_back_reflection(kp, rates, spec.mh_step_s)

    def lp(s):
        out = _marginal_loglik(gtable, s, spec.gen_cap)
        if prior_mu is not None:
            out = out - 0.5 * (s - prior_mu) ** 2 / prior_sigma2
        return out

    log_ratio = lp(prop) - lp(rates)
    u = jax.random.uniform(ku, rates.shape, minval=_EPS)
    return jnp.where(jnp.log(u) < log_ratio, prop, rates)
