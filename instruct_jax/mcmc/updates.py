"""Vectorized Gibbs / Metropolis-Hastings update kernels.

Each function replaces one `update_*` kernel of mcmc.c with a dense device
computation over the whole [N, L] site grid; sweeps over individuals/pops
become vmapped axes (when the conditional factorizes) or a `lax.scan` over
the tiny K axis (when it does not).

Reference parity map:
  update_freq          <- update_P          (mcmc.c:799-861)
  update_zq            <- update_ZQ         (mcmc.c:1122-1203)
  update_z_noadmix     <- update_Z          (mcmc.c:1094-1119)
  update_alpha         <- update_alpha      (mcmc.c:1244-1263), with the
                          *correct* symmetric-Dirichlet density ratio — the
                          reference's pow-product ratio (mcmc.c:1258) drops
                          the Gamma-function normalisers (survey §2.1 quirk)
  update_s_pop         <- update_S_POP      (mcmc.c:913-983) with the
                          proposal() target (mcmc.c:1630-1648)
  update_gen           <- update_G          (mcmc.c:1053-1091)
  update_s_ind         <- update_S_IND      (mcmc.c:864-886)
  update_f_pop         <- update_inbreedcoff_POP (mcmc.c:986-1050), with a
                          correct MH acceptance — the reference exponentiates
                          MIN2(1, logratio) (mcmc.c:1040, survey quirk)
  update_f_ind         <- update_F_IND      (mcmc.c:888-910)
  adaptive independence sampler <- adpt_indp/dt_stat/hastings_stat/q
                          (mcmc.c:1461-1593)
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from instruct_jax.config import ModelSpec
from instruct_jax.data.dataset import Dataset
from instruct_jax.mcmc.state import McmcState, masked_z_counts
from instruct_jax.model import likelihood as lk

# f32 products feeding MH ratios / log-likelihoods: never TF32
_HI = jax.lax.Precision.HIGHEST

_EPS = 1e-30


def _slog(x):
    return jnp.log(jnp.maximum(x, _EPS))


def _psum(x, axis_name):
    """Cross-shard sum over the loci ("data") mesh axis; identity when the
    step runs unsharded.  These calls are the ONLY communication in the
    sharded step (parallel/loci_shard.py)."""
    return x if axis_name is None else jax.lax.psum(x, axis_name)


def shard_key(key, axis_name):
    """Per-shard PRNG stream for draws whose sites are device-local (z,
    P): fold the shard index in so shards never replay each other's
    uniform planes.  Draws that must be REPLICATED across shards (Q,
    alpha, S/F proposals, MH accept uniforms) use the unfolded key — their
    inputs are psummed, so identical keys keep them bitwise identical on
    every shard."""
    if axis_name is None:
        return key
    return jax.random.fold_in(key, jax.lax.axis_index(axis_name))


def dirichlet_from_counts(key, conc, valid=None):
    """Sample Dirichlet(conc) rows by gamma-normalisation, respecting a
    padding mask (replaces rdirich, random.c — gamma draws + normalize)."""
    safe = jnp.maximum(conc, 1e-6)
    if valid is not None:
        safe = jnp.where(valid, safe, 1.0)
    g = jax.random.gamma(key, safe)
    if valid is not None:
        g = jnp.where(valid, g, 0.0)
    return g / jnp.maximum(g.sum(-1, keepdims=True), _EPS)


# ---------------------------------------------------------------------------
# P — allele frequencies
# ---------------------------------------------------------------------------

def allele_pop_counts(spec: ModelSpec, data: Dataset, z, zz) -> jnp.ndarray:
    """seqpop f32[K, L, A]: valid allele copies per (pop, locus, allele)
    (the counting loops of update_P, mcmc.c:815-845).

    Layout note: no [., K]/[., A]-trailing one-hots — the (pop, allele)
    cells are a static double loop of masked [N, L] reductions that XLA
    fuses, keeping the loci axis on the 128-lane dimension.
    Mode 0: the per-individual count matrix contracted with one-hot(zz).
    """
    l, p = data.n_loci, data.ploid
    a = data.allele_valid.shape[1]
    k = spec.n_pops
    if spec.mode == 0 and spec.ploid == 2:
        cnt = lk.allele_count_matrix(data)                  # [N, A, L]
        rows = [jnp.einsum("n,nal->al", (zz == kk).astype(jnp.float32), cnt,
                           precision=_HI)
                for kk in range(k)]
        return jnp.stack(rows).transpose(0, 2, 1)           # [K, L, A]
    geno_c = lk.split_copies(data.geno, p)
    z_c = lk.split_copies(z, p)
    valid = data.site_valid
    out = []
    for kk in range(k):
        per_allele = []
        for ai in range(a):
            acc = jnp.zeros((l,), jnp.float32)
            for c in range(p):
                m = valid & (z_c[c] == kk) & (geno_c[c] == ai)
                acc = acc + m.astype(jnp.float32).sum(axis=0)
            per_allele.append(acc)
        out.append(jnp.stack(per_allele, axis=-1))          # [L, A]
    return jnp.stack(out)                                   # [K, L, A]


def update_freq(key, spec: ModelSpec, data: Dataset, z, zz,
                axis_name=None) -> jnp.ndarray:
    """P | Z ~ Dirichlet(counts + 1) per (pop, locus), padded alleles masked
    (update_P, mcmc.c:846-857; the +1 pseudocount is lambda=1.0 at
    mcmc.c:805).  Under loci sharding the counts and the draw are fully
    local (per-locus); only the key is shard-folded."""
    counts = allele_pop_counts(spec, data, z, zz)
    return dirichlet_from_counts(shard_key(key, axis_name), counts + 1.0,
                                 data.allele_valid[None])


# ---------------------------------------------------------------------------
# Z, Q — assignments and admixture proportions
# ---------------------------------------------------------------------------

def update_zq(key, spec: ModelSpec, data: Dataset, freq, q, alpha,
              init: bool = False, axis_name=None, active=None
              ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gibbs z per allele copy then Q | Z ~ Dirichlet(counts + alpha)
    (update_ZQ, mcmc.c:1122-1199).

    z[n,s] ~ Cat_k( q[n,k] * freq[k, l, a_{ns}] ) — mcmc.c:1146;
    at init (init_flag=1) z is uniform over pops — mcmc.c:1144.
    z is flat i32[N, S]; sampling is inverse-CDF over the tiny K axis as a
    static loop, so no [., K]-trailing tensor is ever materialized.
    Under loci sharding the z draws are shard-local; the pop counts are
    psummed before the (replicated) Q draw.  Returns (z, q, qqnum) with
    qqnum the GLOBAL counts.
    """
    kz, kq = jax.random.split(key)
    kz = shard_key(kz, axis_name)
    n, s = data.geno.shape
    k = spec.n_pops
    if init:
        z = jax.random.randint(kz, (n, s), 0, k, dtype=jnp.int8)
    else:
        terms = [q[:, kk][:, None] * pk
                 for kk, pk in enumerate(lk.per_pop_copy_probs(freq, data))]
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        u = jax.random.uniform(kz, (n, s)) * total
        z = jnp.zeros((n, s), jnp.int8)
        cum = jnp.zeros_like(total)
        for kk in range(k - 1):
            cum = cum + terms[kk]
            z = z + (u > cum).astype(jnp.int8)
    qqnum = _psum(masked_z_counts(z, data, k), axis_name)
    q_new = dirichlet_from_counts(
        kq, qqnum + alpha,
        None if active is None else (active > 0)[None, :])
    return z, q_new, qqnum


def update_z_noadmix(key, data: Dataset, freq, axis_name=None,
                     active=None) -> jnp.ndarray:
    """Mode 0: one z per individual, Gibbs over K with full-genome log-liks
    (update_Z, mcmc.c:1094-1119 via log_ld_indv_K).  The [N, K] log-lik
    matrix sums over loci -> psummed; the draw is replicated."""
    ll = _psum(lk.loglik_matrix_nopop_admix(data, freq), axis_name)  # [N, K]
    if active is not None:
        ll = jnp.where((active > 0)[None, :], ll, -jnp.inf)
    return jax.random.categorical(key, ll, axis=-1)


# Round-5 sampler-design note (why there is no "marginal-Q refresh" move
# here): the honest per-chain ESS diagnosis found the sweep's slow mode is
# the Q<->Z mutual reinforcement (q autocorrelation rho_1 = 0.99 at
# 1000x10k; S and G inherit it through sbar) — the classic STRUCTURE-Gibbs
# pathology, shared by the reference (mcmc.c:1122-1199).  An extra MH move
# accepting q' on the Z-MARGINALIZED likelihood while keeping z is NOT a
# valid kernel on the joint posterior (measured: it shifts E[logL] by
# ~1.5%), and the correct collapsed (q, z)-joint variant requires the z
# refresh to be an EXACT draw from p(z | q, data) for the marginal ratio
# to telescope — but the reference's per-copy Z kernel draws each copy
# independently ~ Cat(q_k p_k), which is only approximate Gibbs when the
# selfing/inbreeding genofreq couples the two copies at same-z sites.
# A second experiment sharpened the picture: an EXACT joint (z0, z1)
# K^2-category Gibbs draw (pair weights q_k0 q_k1 exp(site_loglik),
# verified against site_loglik pair-by-pair and by empirical draw
# frequencies) was built and then REMOVED, because combined with the rest
# of the sweep it recovers S *worse* than the per-copy kernel on data
# generated from the structure-way model itself (measured S = [0.35, 0.81]
# vs per-copy [0.09, 0.78], truth [0.1, 0.8]).  The reason: the conjugate
# P update (Dirichlet on OBSERVED allele counts, update_P/mcmc.c:799-861)
# is itself not the genofreq-model conditional — a selfing-collapsed
# homozygote's two observed copies are not two independent draws from
# p_z — so the reference's sweep is a set of MUTUALLY CALIBRATED
# approximations (each treats the copy pair as independent draws), and
# exactifying one kernel alone breaks the cancellation.  The per-copy
# sweep's calibration is verified by
# tests/test_driver.py::test_structure_way_generator_recovery; the
# written-model-exact targets remain the HMC/NUTS/SMC paths (samplers/),
# whose densities are explicit.  Full numbers in BASELINE.md (round 5).


# ---------------------------------------------------------------------------
# alpha — concentration of the Q prior
# ---------------------------------------------------------------------------

def update_alpha(key, spec: ModelSpec, q, alpha, active=None) -> jnp.ndarray:
    """MH on alpha with a Normal(alpha, 1) proposal (update_alpha,
    mcmc.c:1244-1263).

    Target: prod_i Dirichlet(q_i | alpha * 1_K).  We use the correct density
    ratio including the Gamma normalisers
        N [lnG(K a') - K lnG(a')] - N [lnG(K a) - K lnG(a)]
        + (a' - a) sum_{i,m} log q_im,
    where the reference's ratio (mcmc.c:1258) keeps only the pow() products.
    Proposals <= 0 are rejected outright, as in the reference.
    With ``active`` (padded K-selection grid) the density is over the
    active slots only: k becomes the runtime active count and the log-q
    sum is masked (inactive columns hold exact zeros).
    """
    ku, ka = jax.random.split(key)
    prop = alpha + spec.alpha_sd * jax.random.normal(ka)
    n = q.shape[0]
    if active is None:
        k = spec.n_pops
        sum_log_q = _slog(q).sum()
    else:
        k = jnp.maximum(active.sum(), 1.0)
        sum_log_q = (_slog(q) * active[None, :]).sum()

    def norm_term(a):
        return n * (jax.lax.lgamma(k * a) - k * jax.lax.lgamma(a))

    safe_prop = jnp.maximum(prop, 1e-6)
    log_ratio = (norm_term(safe_prop) - norm_term(alpha)
                 + (safe_prop - alpha) * sum_log_q)
    accept = (prop > 0) & (jnp.log(jax.random.uniform(ku, minval=_EPS))
                           < log_ratio)
    return jnp.where(accept, safe_prop, alpha)


# ---------------------------------------------------------------------------
# Proposals for [0,1]-valued rates: back-reflection & adaptive independence
# ---------------------------------------------------------------------------

def back_reflect(x):
    """Reflective bounds on [0,1] (mcmc.c:942-945)."""
    x = jnp.abs(x)
    return jnp.where(x >= 1.0, 2.0 - x, x)


def propose_back_reflection(key, rates, delta0):
    """Random walk +-delta0 with reflection (mcmc.c:939-945)."""
    step = jax.random.uniform(key, rates.shape) * 2.0 * delta0 - delta0
    return back_reflect(rates + step)


def propose_adaptive_independence(key, rates, ais_state):
    """3-state adaptive independence sampler (adpt_indp, mcmc.c:1461-1519).

    States: 0 -> {0}, 1 -> (0,1), 2 -> {1}.  Transition kernel:
      from 0: 0.5 stay at 0.0, 0.5 draw U(0,1)
      from 2: 0.5 stay at 1.0, 0.5 draw U(0,1)
      from 1: 0.05 -> 0.0, 0.05 -> 1.0, 0.90 draw U(0,1)
    Returns (proposed_rates, proposed_state, log_hastings) where
    log_hastings = sum log q(prev|new)/q(new|prev) (hastings_stat,
    mcmc.c:1550-1593); elements are combined per-coordinate so callers
    updating one coordinate at a time can index into it.
    """
    ku, kv = jax.random.split(key)
    u = jax.random.uniform(ku, rates.shape)
    fresh = jax.random.uniform(kv, rates.shape)

    # next state
    st0 = jnp.where(u < 0.5, 0, 1)
    st2 = jnp.where(u < 0.5, 2, 1)
    st1 = jnp.where(u <= 0.05, 0, jnp.where(u >= 0.95, 2, 1))
    new_state = jnp.where(ais_state == 0, st0,
                          jnp.where(ais_state == 2, st2, st1))
    new_rates = jnp.where(new_state == 0, 0.0,
                          jnp.where(new_state == 2, 1.0, fresh))

    def q_trans(a, b):
        # q(a -> b) as in q() (mcmc.c:1566-1593)
        from0 = jnp.where(b == 2, 0.0, 0.5)
        from2 = jnp.where(b == 0, 0.0, 0.5)
        from1 = jnp.where(b == 1, 0.90, 0.05)
        return jnp.where(a == 0, from0, jnp.where(a == 2, from2, from1))

    log_hastings = (_slog(q_trans(new_state, ais_state))
                    - _slog(q_trans(ais_state, new_state)))
    return new_rates, new_state, log_hastings


# ---------------------------------------------------------------------------
# S — selfing rates
# ---------------------------------------------------------------------------

def _geom_loglik(sbar, gen):
    """sum_i log( sbar_i^{gen_i - 1} (1 - sbar_i) ) — proposal(),
    mcmc.c:1630-1648.  gen==1 contributes no sbar term even when sbar==0."""
    g1 = (gen - 1).astype(sbar.dtype)
    t = jnp.where(g1 > 0, g1 * _slog(sbar), 0.0) + _slog(1.0 - sbar)
    return t.sum()


def update_s_pop(key, spec: ModelSpec, q, gen, rates, ais_state):
    """Mode 2: MH per subpopulation on S (update_S_POP, mcmc.c:913-983).

    Target is the likelihood of the generation latents given the expected
    per-individual selfing rate sbar_i = sum_k q_ik s_k (proposal(),
    mcmc.c:1630-1648).  Pops are updated one at a time (the target couples
    them through sbar) via a lax.scan over the K axis; each evaluation is
    O(N) thanks to the rank-1 update sbar' = sbar + q[:, j] (s'_j - s_j).
    """
    k = spec.n_pops
    # disjoint accept/proposal streams: fold_in(key, j) is bit-identical
    # to split(key, k)[j], so deriving kprop by fold_in would alias pop
    # j=17's accept uniform with the proposal draws at K >= 18 (ADVICE r4)
    kacc, kprop = jax.random.split(key)
    keys = jax.random.split(kacc, k)

    if spec.back_refl == 1:
        proposals = propose_back_reflection(kprop, rates, spec.mh_step_s)
        prop_states = ais_state
        log_hast = jnp.zeros((k,))
    else:
        proposals, prop_states, log_hast = propose_adaptive_independence(
            kprop, rates, ais_state)

    def body(carry, j):
        rates_c, states_c, sbar = carry
        s_new = proposals[j]
        sbar_new = sbar + q[:, j] * (s_new - rates_c[j])
        log_ratio = (_geom_loglik(sbar_new, gen) - _geom_loglik(sbar, gen)
                     + log_hast[j])
        u = jax.random.uniform(keys[j], minval=_EPS)
        accept = jnp.log(u) < log_ratio
        rates_c = rates_c.at[j].set(jnp.where(accept, s_new, rates_c[j]))
        states_c = states_c.at[j].set(
            jnp.where(accept, prop_states[j], states_c[j]))
        sbar = jnp.where(accept, sbar_new, sbar)
        return (rates_c, states_c, sbar), None

    sbar0 = jnp.dot(q, rates, precision=_HI)
    (rates, ais_state, _), _ = jax.lax.scan(
        body, (rates, ais_state, sbar0), jnp.arange(k))
    return rates, ais_state


def update_s_ind(key, spec: ModelSpec, gen, rates, prior_mu=None,
                 prior_sigma2=None):
    """Mode 3: per-individual MH random walk on S with the geometric
    likelihood of G (update_S_IND, mcmc.c:864-886).  Individuals are
    conditionally independent, so all N proposals run in parallel.

    With the normal prior (`-f 2`), the acceptance ratio additionally
    carries N(mu, sigma^2) prior terms — the hierarchy the reference's
    README advertises whose sampler survives only as sample_mu2
    (mcmc.c:1607-1626)."""
    kp, ku = jax.random.split(key)
    prop = propose_back_reflection(kp, rates, spec.mh_step_s)
    g1 = (gen - 1).astype(rates.dtype)

    def lp(s):
        out = jnp.where(g1 > 0, g1 * _slog(s), 0.0) + _slog(1.0 - s)
        if prior_mu is not None:
            out = out - 0.5 * (s - prior_mu) ** 2 / prior_sigma2
        return out

    log_ratio = lp(prop) - lp(rates)
    u = jax.random.uniform(ku, rates.shape, minval=_EPS)
    return jnp.where(jnp.log(u) < log_ratio, prop, rates)


def update_normal_hyper(key, rates, priors):
    """Gibbs update of the normal prior's (mu, sigma^2) given the current
    S/F vector — exact transcription of the conjugate draws in sample_mu2
    (mcmc.c:1607-1626): sigma^2 ~ scaled-inv-chi^2(nu_n, sigmasqr_n),
    mu ~ N(mu_n, sigma^2/kappa_n)."""
    k1, k2 = jax.random.split(key)
    n = rates.shape[0]
    ave = rates.mean()
    kappa_n = priors.normal_kappa0 + n
    nu_n = priors.normal_nu0 + n
    ss = ((ave - rates) ** 2).sum()
    sigmasqr_n = (priors.normal_nu0 * priors.normal_sigmasqr0
                  + priors.normal_kappa0 * (ave - priors.normal_mu0) ** 2
                  + ss)
    sigma2 = sigmasqr_n / (2.0 * jax.random.gamma(k1, nu_n * 0.5))
    mu_n = (priors.normal_kappa0 * priors.normal_mu0 + n * ave) / kappa_n
    mu = mu_n + jnp.sqrt(sigma2 / kappa_n) * jax.random.normal(k2)
    return mu, sigma2


# ---------------------------------------------------------------------------
# G — selfing generations
# ---------------------------------------------------------------------------

def sample_geometric(key, sbar, cap):
    """g ~ Geom(1 - sbar) on {1, 2, ...} clipped to [1, cap] with the
    boundary-state overrides of update_G (mcmc.c:1071-1084): sbar ~= 0 ->
    g = 1, sbar ~= 1 -> g = cap."""
    eps = 1e-3
    u = jax.random.uniform(key, sbar.shape, minval=1e-12, maxval=1.0)
    s = jnp.clip(sbar, 1e-6, 1.0 - 1e-6)
    g = 1 + jnp.floor(jnp.log(u) / jnp.log(s)).astype(jnp.int32)
    g = jnp.clip(g, 1, cap)
    g = jnp.where(sbar <= eps, 1, g)
    g = jnp.where(sbar >= 1.0 - eps, cap, g)
    return g


def update_gen(key, spec: ModelSpec, data: Dataset, freq, z, q, rates,
               gen, axis_name=None, prop=None, logu=None) -> jnp.ndarray:
    """Modes 2/3: MH on the per-individual selfing-generation counts
    (update_G, mcmc.c:1053-1091).

    Proposal g' ~ Geom(1 - sbar_i) equals the conditional prior, so the
    acceptance ratio reduces to the genotype-likelihood ratio
    exp(log_ld_indv(g') - log_ld_indv(g)) — exactly mcmc.c:1085.  All N
    individuals are independent given (P, Z, Q, S): one parallel sweep.
    ``prop`` / ``logu`` take a proposal and accept log-uniforms drawn
    elsewhere (the fused mode-2 S tail draws both).
    """
    kg, ku = jax.random.split(key)
    if prop is None:
        if spec.mode == 2:
            sbar = jnp.dot(q, rates, precision=_HI)   # mcmc.c:1063-1066
        else:
            sbar = rates                              # mcmc.c:1069
        prop = sample_geometric(kg, sbar, spec.gen_cap)
    ll_prop = lk.per_indv_loglik(spec, data, freq, z, q, prop, rates)
    ll_cur = lk.per_indv_loglik(spec, data, freq, z, q, gen, rates)
    diff = _psum(ll_prop - ll_cur, axis_name)
    if logu is None:
        logu = jnp.log(jax.random.uniform(ku, gen.shape, minval=_EPS))
    return jnp.where(logu < diff, prop, gen)


# ---------------------------------------------------------------------------
# F — inbreeding coefficients
# ---------------------------------------------------------------------------

def _f_site_terms(spec, data, freq, z):
    """Shared per-site quantities for the F updates: per-copy probs and the
    joint mask of valid sites whose copies share one pop — only those
    depend on F (log_ld_F_*, mcmc.c:1789-1805)."""
    pz = lk.gather_freq_at_z(freq, data, z)
    p0, p1 = lk.split_copies(pz, data.ploid)
    z0, z1 = lk.split_copies(z, data.ploid)
    mask = (z0 == z1) & data.site_valid
    return p0, p1, z0, mask


def update_f_pop(key, spec: ModelSpec, data: Dataset, freq, z, rates,
                 ais_state, axis_name=None):
    """Mode 4: MH on per-subpop inbreeding coefficients
    (update_inbreedcoff_POP, mcmc.c:986-1050).

    F_j only affects sites with both copies assigned to pop j, so the K
    acceptance decisions decouple and run in parallel: per-site log-ratio,
    segment-summed into K via a one-hot contraction.

    Note: the reference computes `exp(MIN2(1, logratio))` (mcmc.c:1040) —
    a bug acknowledged in the survey; we apply standard MH.
    """
    p0, p1, z0, mask = _f_site_terms(spec, data, freq, z)
    if spec.back_refl == 1:
        prop = propose_back_reflection(jax.random.fold_in(key, 0), rates,
                                       spec.mh_step_s)
        prop_states = ais_state
        log_hast = jnp.zeros_like(rates)
    else:
        prop, prop_states, log_hast = propose_adaptive_independence(
            jax.random.fold_in(key, 0), rates, ais_state)

    f_cur = rates[z0]
    f_prop = prop[z0]
    ll_cur = _slog(lk.genofreq_inbreeding(p0, p1, data.hom, f_cur))
    ll_prop = _slog(lk.genofreq_inbreeding(p0, p1, data.hom, f_prop))
    diff = jnp.where(mask, ll_prop - ll_cur, 0.0)            # [N, L]
    delta = _psum(jnp.stack([
        jnp.where(z0 == kk, diff, 0.0).sum()
        for kk in range(spec.n_pops)]), axis_name)           # [K]
    u = jax.random.uniform(key, rates.shape, minval=_EPS)
    accept = jnp.log(u) < delta + log_hast
    return (jnp.where(accept, prop, rates),
            jnp.where(accept, prop_states, ais_state))


def update_f_ind(key, spec: ModelSpec, data: Dataset, freq, z, rates,
                 prior_mu=None, prior_sigma2=None, axis_name=None):
    """Mode 5: per-individual MH random walk on F (update_F_IND,
    mcmc.c:888-910); individuals independent -> one parallel sweep.
    Optional normal-prior terms as in :func:`update_s_ind`."""
    p0, p1, _z0, mask = _f_site_terms(spec, data, freq, z)
    kp, ku = jax.random.split(key)
    prop = propose_back_reflection(kp, rates, spec.mh_step_s)

    def lp(f):
        site = _slog(lk.genofreq_inbreeding(p0, p1, data.hom, f[:, None]))
        return jnp.where(mask, site, 0.0).sum(axis=1)

    # site terms are psummed over loci shards; prior terms are global
    # (added once, outside the psum)
    log_ratio = _psum(lp(prop) - lp(rates), axis_name)
    if prior_mu is not None:
        log_ratio = log_ratio - (0.5 * (prop - prior_mu) ** 2
                                 - 0.5 * (rates - prior_mu) ** 2) / prior_sigma2
    u = jax.random.uniform(ku, rates.shape, minval=_EPS)
    return jnp.where(jnp.log(u) < log_ratio, prop, rates)


# ---------------------------------------------------------------------------
# Diagnostic helpers shared with the driver
# ---------------------------------------------------------------------------

def empty_cluster_flag(q, active=None) -> jnp.ndarray:
    """True when any cluster's total occupancy sum_i q_ik < 0.01
    (check_empty_cluster, mcmc.c:1944-1974).  Inactive padded slots
    (kselect grid) always have zero occupancy and are exempt."""
    if q.size == 0:
        return jnp.asarray(False)
    low = q.sum(axis=0) < 0.01
    if active is not None:
        low = low & (active > 0)
    return jnp.any(low)
