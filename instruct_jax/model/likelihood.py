"""Fused genotype-likelihood math for the InStruct model family.

Pure functions over dense tensors: every large intermediate keeps the long
loci axis trailing.  Small categorical axes (pops K, alleles A, ploidy P)
are *never* the trailing dim of a big tensor — a [N, L, P, K] one-hot would
cost many times the bytes of the planes it indexes.  Instead the
per-copy site axis is flattened to S = L * ploid ([N, S] tensors) and K/A
become static Python loops over gathers/reductions that XLA fuses.

Reference parity:
  * :func:`genofreq_selfing`      — genofreq(), mcmc.c:1683-1703.
  * :func:`genofreq_inbreeding`   — genofreq_inbreedcoff(), mcmc.c:1707-1723.
  * :func:`site_loglik`           — the per-(indiv,locus) bodies of
    log_ld_indv / log_ld_F_pop / log_ld_F_indv / log_ld_noselfing_indv
    (mcmc.c:1726-1890).
  * :func:`loglik_matrix_nopop_admix` — log_ld_indv_K (mcmc.c:1893-1914),
    all (i, K) pairs as one matmul.

Shape conventions: freq f32[K, L, A]; geno/z flat i32[N, S]; q f32[N, K];
per-site outputs f32[N, L].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from instruct_jax.config import ModelSpec
from instruct_jax.data.dataset import Dataset

# f32 products feeding MH ratios / log-likelihoods: never TF32
_HI = jax.lax.Precision.HIGHEST

_LOG2 = 0.6931471805599453
_EPS = 1e-30  # guards log(0) for Dirichlet draws that underflow


def genofreq_selfing(p0, p1, hom, gen):
    """Genotype frequency after `gen` generations of selfing.

    Homozygote:   p0^ploid + p0(1-p0) (1 - 2^{1-gen})
    Heterozygote: 2 p0 p1 2^{1-gen}

    Matches the loop in genofreq() (mcmc.c:1688-1702): the reference
    accumulates sum_{i=1}^{g-1} p(1-p)/2^i which telescopes to the closed
    form above; the heterozygote branch is explicit at mcmc.c:1700.
    """
    w = jnp.exp2(1.0 - jnp.asarray(gen, dtype=p0.dtype))
    hom_freq = p0 * p0 + p0 * (1.0 - p0) * (1.0 - w)
    het_freq = 2.0 * p0 * p1 * w
    return jnp.where(hom, hom_freq, het_freq)


def genofreq_inbreeding(p0, p1, hom, f):
    """Genotype frequency under inbreeding coefficient F
    (genofreq_inbreedcoff, mcmc.c:1707-1723):
    hom p^2(1-F) + pF ; het 2 p0 p1 (1-F)."""
    hom_freq = p0 * p0 * (1.0 - f) + p0 * f
    het_freq = 2.0 * p0 * p1 * (1.0 - f)
    return jnp.where(hom, hom_freq, het_freq)


def _safe_log(x):
    return jnp.log(jnp.maximum(x, _EPS))


def flat_site_index(data: Dataset) -> jnp.ndarray:
    """lin i32[N, S]: flattened (locus, allele) gather index l*A + a for
    every allele copy, S = L * ploid."""
    l, p = data.n_loci, data.ploid
    a = data.allele_valid.shape[1]
    l_of_s = jnp.tile(jnp.arange(l, dtype=jnp.int32), p)[None]
    return l_of_s * a + data.geno.astype(jnp.int32)


# Above this many (pop, allele) cells the select formulation stops paying
# off and we fall back to one big gather: a fused select chain is one
# memory pass, a gather with millions of arbitrary indices is not.  The
# crossover awaits a measurement on the GPU.
_SELECT_MAX_CELLS = 256


def _freq_per_site(freq_col, ploid):
    """[L] per-locus values -> [S] per-copy values (the locus row tiled
    once per copy plane, copy-major layout) — a broadcast, NOT a gather."""
    return jnp.tile(freq_col, ploid)[None, :]


def gather_freq_at_z(freq, data: Dataset, z) -> jnp.ndarray:
    """p f32[N, S]: freq[z[n,l,c], l, geno[n,l,c]] in flat layout — the
    ubiquitous `ptr->freq[z...][j][seqdata...]` gather (mcmc.c:1756).

    Perf note: for small K*A this is computed as a static
    select-accumulate over the (pop, allele) grid instead of a gather with
    tens of millions of arbitrary indices (one linear pass per cell)."""
    l = data.n_loci
    a = data.allele_valid.shape[1]
    k = freq.shape[0]
    if k * a <= _SELECT_MAX_CELLS:
        p = data.ploid
        out = jnp.zeros(data.geno.shape, freq.dtype)
        for kk in range(k):
            zm = z == kk
            for ai in range(a):
                vals = _freq_per_site(freq[kk, :, ai], p)
                out = jnp.where(zm & (data.geno == ai), vals, out)
        return out
    lin = flat_site_index(data)                           # [N, S]: l*A + a
    idx = z.astype(jnp.int32) * (l * a) + lin             # into [K*L*A]
    return jnp.take(freq.reshape(-1), idx, axis=None)


def per_pop_copy_probs(freq, data: Dataset):
    """Generator over k of p_k f32[N, S] = freq[k, l, a_{nlc}] — per-copy
    allele prob under pop k (the inner quantity of the Z-Gibbs update,
    mcmc.c:1146), yielded per pop to avoid a K-trailing tensor.  Same
    select-vs-gather policy as :func:`gather_freq_at_z`."""
    l = data.n_loci
    a = data.allele_valid.shape[1]
    k = freq.shape[0]
    if k * a <= _SELECT_MAX_CELLS:
        p = data.ploid
        for kk in range(k):
            out = _freq_per_site(freq[kk, :, 0], p) * (data.geno == 0)
            for ai in range(1, a):
                vals = _freq_per_site(freq[kk, :, ai], p)
                out = jnp.where(data.geno == ai, vals, out)
            yield out
        return
    lin = flat_site_index(data)
    flat = freq.reshape(freq.shape[0], l * a)
    for kk in range(freq.shape[0]):
        yield jnp.take(flat[kk], lin, axis=None)


def mixture_copy_probs(freq, data: Dataset, q) -> jnp.ndarray:
    """Expectation-way per-copy probability f32[N, S]:
    p = sum_m q[n,m] freq[m, l, a] (mcmc.c:1741-1745)."""
    out = None
    for k, pk in enumerate(per_pop_copy_probs(freq, data)):
        term = q[:, k][:, None] * pk
        out = term if out is None else out + term
    return out


def split_copies(flat, p):
    """[N, S] -> tuple of per-copy [N, L] planes (contiguous slices in the
    copy-major layout s = c * L + l)."""
    l = flat.shape[1] // p
    return tuple(flat[:, c * l:(c + 1) * l] for c in range(p))


def site_loglik(
    spec: ModelSpec,
    data: Dataset,
    freq: jnp.ndarray,
    z: jnp.ndarray,
    q: jnp.ndarray | None,
    gen: jnp.ndarray | None,
    rates: jnp.ndarray | None,
) -> jnp.ndarray:
    """Per-site log-likelihood f32[N, L] for the admixture modes (1-5);
    ``z`` is flat i32[N, S].

    Dispatches exactly like cal_lkh (mcmc.c:1916-1942):
      mode 1            -> log_ld_noselfing_indv body (mcmc.c:1869-1890)
      modes 2/3         -> log_ld_indv body (mcmc.c:1726-1773), honoring
                           spec.type_freq (expectation vs structure way)
      modes 4/5         -> log_ld_F_pop / log_ld_F_indv bodies
                           (mcmc.c:1776-1847)
    Invalid sites are forced to 0; callers sum over L.
    """
    p = data.ploid
    hom = data.hom
    het = ~hom

    if spec.mode in (2, 3) and spec.type_freq == 0:
        # Expectation way: mixture per-copy probs, no dependence on z.
        pm = mixture_copy_probs(freq, data, q)            # [N, S]
        p0, p1 = split_copies(pm, p)
        g = gen[:, None].astype(p0.dtype)
        site = _safe_log(genofreq_selfing(p0, p1, hom, g))
        return jnp.where(data.site_valid, site, 0.0)

    pz = gather_freq_at_z(freq, data, z)                  # [N, S]
    p0, p1 = split_copies(pz, p)
    sum_log_pz = _safe_log(p0) + _safe_log(p1)
    indep = sum_log_pz + jnp.where(het, _LOG2, 0.0)       # product + het*log2
    z0, z1 = split_copies(z, p)
    if spec.mode == 1:
        site = indep                                      # mcmc.c:1877-1888
    else:
        same_z = z0 == z1
        if spec.mode in (2, 3):
            g = gen[:, None].astype(p0.dtype)
            joint = _safe_log(genofreq_selfing(p0, p1, hom, g))
        else:  # modes 4/5: inbreeding coefficient
            if spec.mode == 4:
                f = rates[z0]                             # F of pop z[...,0]
                # (log_ld_F_pop uses inbreed[z[i][j][0]], mcmc.c:1795)
            else:
                f = rates[:, None]                        # broadcast over loci
            joint = _safe_log(genofreq_inbreeding(p0, p1, hom, f))
        site = jnp.where(same_z, joint, indep)
    return jnp.where(data.site_valid, site, 0.0)


def per_indv_loglik(spec, data, freq, z, q, gen, rates) -> jnp.ndarray:
    """f32[N] per-individual log-lik (the `indvlkh` of cal_lkh,
    mcmc.c:1916-1942)."""
    return site_loglik(spec, data, freq, z, q, gen, rates).sum(axis=1)


def marginal_site_loglik(
    spec: ModelSpec,
    data: Dataset,
    freq: jnp.ndarray,
    q: jnp.ndarray,
    gen: jnp.ndarray | None,
    rates: jnp.ndarray | None,
) -> jnp.ndarray:
    """Per-site log-likelihood f32[N, L] with the per-copy ancestries Z
    summed out EXACTLY (modes 1-5, diploid).

    Given (P, Q, G/F) the two copies' assignments are iid Cat(q_i), so the
    per-locus marginal is the 2-copy mixture

        sum_k q_ik^2 * joint_k  +  (m0 m1 - sum_k q_ik^2 p_k0 p_k1) * mult

    where joint_k is the same-pop genotype probability (genofreq under
    selfing for modes 2/3 — mcmc.c:1683-1703 —, the inbreeding form for
    modes 4/5 — mcmc.c:1707-1723 —, the plain product for mode 1),
    m_c = sum_k q_ik p_kc is the mixture per-copy probability, and
    mult = 2 for heterozygotes (unordered genotype) and 1 for homozygotes.
    The cross term collapses the K^2 unequal-pop pairs to one rank-1
    correction, so the whole pass is K plane sweeps like every other site
    kernel.

    This is the deviance focus used by the *corrected* DIC (the reference's
    DIC degenerates to -2 E[logL] because its "plug-in" term re-uses the
    posterior-mean log-lik, result_analysis.c:403-411; survey §2.1 quirk
    list): both the running E[logL] term and the plug-in term evaluate this
    same marginal, so pD = 2(logL(theta_bar) - E[logL]) is a real
    complexity penalty.  ``gen`` may be real-valued (posterior means) —
    genofreq_selfing's closed form extends smoothly via 2^{1-g}.
    """
    p = data.ploid
    hom = data.hom
    mult = jnp.where(hom, 1.0, 2.0)
    m0 = m1 = same = joint = 0.0
    for k, pk in enumerate(per_pop_copy_probs(freq, data)):
        pk0, pk1 = split_copies(pk, p)
        qk = q[:, k][:, None]
        m0 = m0 + qk * pk0
        m1 = m1 + qk * pk1
        same = same + (qk * qk) * (pk0 * pk1)
        if spec.mode in (2, 3):
            g = gen[:, None].astype(pk0.dtype)
            jk = genofreq_selfing(pk0, pk1, hom, g)
        elif spec.mode in (4, 5):
            f = rates[k] if spec.mode == 4 else rates[:, None]
            jk = genofreq_inbreeding(pk0, pk1, hom, f)
        else:  # mode 1: plain product; mult applied uniformly below
            jk = pk0 * pk1
        joint = joint + (qk * qk) * jk
    cross = m0 * m1 - same
    if spec.mode == 1:
        prob = (joint + cross) * mult          # = mult * m0 * m1
    else:
        # genofreq_* already carries the het factor 2 in joint_k
        prob = joint + cross * mult
    site = _safe_log(prob)
    return jnp.where(data.site_valid, site, 0.0)


def marginal_indv_loglik(spec, data, freq, q, gen, rates) -> jnp.ndarray:
    """f32[N] Z-marginalized per-individual log-lik (sum of
    :func:`marginal_site_loglik` over loci; psum by the caller under loci
    sharding)."""
    return marginal_site_loglik(spec, data, freq, q, gen, rates).sum(axis=1)


def allele_count_matrix(data: Dataset) -> jnp.ndarray:
    """cnt f32[N, A, L]: per individual, per (allele, locus), the number of
    valid copies carrying that allele — laid out with L trailing.  Reused
    by mode-0 likelihood and the no-admixture P-count (update_P's mode==0
    branch, mcmc.c:825-831)."""
    n = data.geno.shape[0]
    l, p = data.n_loci, data.ploid
    a = data.allele_valid.shape[1]
    cols = []
    valid = data.site_valid
    geno_c = split_copies(data.geno, p)
    for ai in range(a):
        cnt = jnp.zeros((n, l), jnp.float32)
        for c in range(p):
            cnt = cnt + jnp.where(valid & (geno_c[c] == ai), 1.0, 0.0)
        cols.append(cnt)
    return jnp.stack(cols, axis=1)                        # [N, A, L]


def loglik_matrix_nopop_admix(data: Dataset, freq: jnp.ndarray) -> jnp.ndarray:
    """ll f32[N, K]: log-lik of each individual under a single-pop
    assignment to every k — log_ld_indv_K (mcmc.c:1893-1914) for all (i, K)
    as one matmul: ll = cnt @ log(freq)^T + het_bonus."""
    n, l = data.geno.shape[0], data.n_loci
    a = data.allele_valid.shape[1]
    cnt = allele_count_matrix(data).reshape(n, a * l)     # [N, A*L]
    logf = _safe_log(jnp.maximum(freq, 0.0))
    logf = jnp.where(data.allele_valid[None], logf, 0.0)
    logf = jnp.transpose(logf, (0, 2, 1)).reshape(-1, a * l)  # [K, A*L]
    ll = jnp.dot(cnt, logf.T, precision=_HI)              # [N, K]
    het_bonus = (jnp.where(~data.hom, _LOG2, 0.0)
                 * data.site_valid).sum(axis=1)
    return ll + het_bonus[:, None]
