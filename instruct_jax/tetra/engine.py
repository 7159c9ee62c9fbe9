"""Tetraploid (auto / allo) MCMC engine — mcmc_POP_tetra_selfing rebuilt
as vectorized device code (reference: poly_geno.c:75-140 and callees).

Redesign relative to the C reference:
  * genotype identities are dense class indices via a precomputed packed-
    code lookup (combinatorics.py) — no `find_id` linear scans;
  * the selfing equilibrium (I - s A) P = (1 - s) R is a *batched linear
    solve* over (pop, loci-of-class), replacing the staged
    scalar back-substitution + 3x3 Gauss-Jordan (auto_genfreq/gaussj,
    poly_geno.c:1803-2028, 2384-2435).  A is column-stochastic, which
    guarantees the solved frequencies sum to one — the invariant the
    reference asserts after every category;
  * the latent-ordering Gibbs move (update_geno, poly_geno.c:520-580)
    samples all (indiv, locus) sites in parallel from a static candidate
    bank; canonical-form repair is unnecessary because every candidate
    pattern is canonical by construction;
  * S updates decouple across pops (a pop's table only scores sites whose
    copies all sit in that pop), so the K MH decisions run in parallel;
  * memory layout: allele copies and latent genotypes are flat [N, S4]
    (S4 = L*4) and all small categorical axes (K, alleles, candidates) are
    static loops — no small-trailing-dim tensors.

Documented divergences from the reference (intent over bug):
  * allo Z-Gibbs uses freq2 for subgenome-2 copies (the reference samples
    all four copies from system-1 freq, poly_geno.c:773);
  * the latent-ordering weights use the exact class multiplicities; the
    reference's choose_*_allo drops a factor 2 for heterozygous-subgenome
    candidates (poly_geno.c:1010-1022);
  * monomorphic loci are masked out (constant likelihood either way).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from instruct_jax.config import ModelSpec
from instruct_jax.data.dataset import Dataset
from instruct_jax.mcmc import updates as up
from instruct_jax.mcmc.state import McmcState, _dt_stat
from instruct_jax.tetra.combinatorics import (ALLO_PATTERNS, AUTO_PATTERNS,
                                              build_class_tables)

_EPS = 1e-30
_NEG = -1e30


def _slog(x):
    return jnp.log(jnp.maximum(x, _EPS))


class TetraTables(NamedTuple):
    """Device-resident per-locus tables (+ static host metadata)."""

    cls: jnp.ndarray          # i32[L] table-stack index of each locus
    gvalid: jnp.ndarray       # bool[C, G]
    log_mult: jnp.ndarray     # f32[C, G]
    lookup: jnp.ndarray       # i32[C, n_max^4]
    self_mat: jnp.ndarray     # f32[C, G, G]
    digits_np: np.ndarray     # host [C, G, 4]
    patterns_np: np.ndarray   # host [5, P_max, 4] candidate orderings
    n_patterns_np: np.ndarray  # host [5]
    n_max: int
    g_max: int
    class_loci: tuple         # ((class_idx, np loci indices, G), ...) static
    # Static per-candidate site planes (data-only, precomputed once at
    # build: the genotype move's candidate orderings route the OBSERVED
    # distinct-allele sets through the pattern bank, so their slot
    # arrangement, class index and ordering multiplicity never change
    # during sampling).  Precomputing them shrank the unrolled step graph
    # ~2.5x — the per-candidate 256-way lookup select chains made the
    # allotetraploid step take tens of minutes to COMPILE.
    # Memory: ~4 bytes * n_candidates * N * L (~120 MB at 500x5k, C=12).
    cand_sel: jnp.ndarray = None   # u8[C, N, L] packed 2-bit distinct-slot
    #   indices, slot m at bits [2m, 2m+2)
    cand_cls: jnp.ndarray = None   # i16[C, N, L] genotype-class index
    cand_mult: jnp.ndarray = None  # u8[C, N, L] ordering multiplicity
    cand_nc: jnp.ndarray = None    # u8[N, L] number of valid candidate
    #   orderings at each site (n_patterns routed through n_distinct) —
    #   static data, precomputed for the Pallas genotype-move kernel


# Identity-keyed memo for the CANDIDATE-FREE tables only: the chain
# driver, the model-choice pass (step.build_marg_loglik) and the plug-in
# deviance all build tables for the same panel in one run_mcmc call, and
# the host combinatorics are worth sharing.  with_candidates=True tables
# are deliberately NOT cached — their [C, N, L] device planes (~120 MB at
# 500x5k) would stay pinned for process lifetime (round-5 self-review).
# The key checks BOTH geno and allele_valid identity: two Datasets could
# share a geno array while differing in the allele layout that drives the
# class tables.
_TABLES_CACHE: list = []


def build_tables(spec: ModelSpec, data: Dataset,
                 with_candidates: bool = True) -> TetraTables:
    """``with_candidates=False`` skips the [C, N, L] candidate planes —
    the chain driver passes the panel as a RUNTIME argument and rebuilds
    the planes in-trace (retable_candidates), so materializing concrete
    ones would embed gigabytes of dead device constants at biobank
    panel sizes."""
    if with_candidates:
        return _build_tables(spec, data, True)
    ap = bool(spec.autopoly)
    for g, av, k, tab in _TABLES_CACHE:
        if g is data.geno and av is data.allele_valid and k == ap:
            return tab
    tab = _build_tables(spec, data, False)
    _TABLES_CACHE.append((data.geno, data.allele_valid, ap, tab))
    if len(_TABLES_CACHE) > 6:
        _TABLES_CACHE.pop(0)
    return tab


def _build_tables(spec: ModelSpec, data: Dataset,
                  with_candidates: bool = True) -> TetraTables:
    n_alleles = np.asarray(data.allele_valid).sum(-1).astype(np.int32)
    ct = build_class_tables(n_alleles, spec.autopoly)
    cls = ct.class_of_locus(n_alleles)
    pat_bank = AUTO_PATTERNS if spec.autopoly else ALLO_PATTERNS
    p_max = max(p.shape[0] for p in pat_bank.values())
    patterns = np.zeros((5, p_max, 4), np.int32)
    n_patterns = np.zeros(5, np.int32)
    for cnt, pats in pat_bank.items():
        patterns[cnt, :pats.shape[0]] = pats
        n_patterns[cnt] = pats.shape[0]
    class_loci = tuple(
        (ci, np.nonzero(cls == ci)[0], int(ct.g_count[ci]))
        for ci in range(len(ct.allele_counts))
        if (cls == ci).any())
    tab = TetraTables(
        cls=jnp.asarray(cls),
        gvalid=jnp.asarray(ct.valid), log_mult=jnp.asarray(ct.log_mult),
        lookup=jnp.asarray(ct.lookup), self_mat=jnp.asarray(ct.self_mat),
        digits_np=ct.digits, patterns_np=patterns, n_patterns_np=n_patterns,
        n_max=ct.n_max, g_max=ct.g_max, class_loci=class_loci)
    if not with_candidates:
        return tab
    cand_sel, cand_cls, cand_mult = _candidate_planes(tab, data)
    cnt_np = np.clip(np.asarray(data.n_distinct), 1, 4)
    cand_nc = jnp.asarray(n_patterns[cnt_np].astype(np.uint8))
    return tab._replace(cand_sel=cand_sel, cand_cls=cand_cls,
                        cand_mult=cand_mult, cand_nc=cand_nc)


def _split4(flat):
    """Slot views of a copy-major flat tetra tensor [N, 4L] (slot m at
    columns [m*L, (m+1)*L) — the same layout as Dataset.geno), upcast to
    int32 so callers can pack/compare without int8 overflow."""
    l = flat.shape[1] // 4
    return tuple(flat[:, m * l:(m + 1) * l].astype(jnp.int32)
                 for m in range(4))

# Above this many table cells the select formulation stops paying off and we
# fall back to a gather (cf. likelihood._SELECT_MAX_CELLS): a select chain
# is one memory pass over the site planes.  512 covers the allotetraploid
# K*G_allo = 3 * 100 = 300 cells of _table_at at A=4, which the allo
# genotype move looks up 12 times per step.  The crossover awaits a
# measurement on the GPU.
_SELECT_MAX_CELLS = 512


def _select_or_gather(table_lv, idx):
    """out[n, l] = table_lv[l, idx[n, l]] — static select loop for small V,
    flat gather otherwise.  table_lv f32/i32[L, V], idx i32[N, L]."""
    l, v = table_lv.shape
    if v <= _SELECT_MAX_CELLS:
        out = jnp.broadcast_to(table_lv[:, 0][None], idx.shape)
        out = out.astype(table_lv.dtype)
        for vi in range(1, v):
            out = jnp.where(idx == vi, table_lv[:, vi][None], out)
        return out
    flat_idx = jnp.arange(l)[None, :] * v + idx
    return jnp.take(table_lv.reshape(-1), flat_idx, axis=None)


def _mix_per_allele(freq, q):
    """list over alleles a of m_a f32[N, L] = sum_k q[n,k] freq[k,l,a]
    (the Q-mixture the reference uses for mixed-z ordering weights,
    poly_geno.c:879-891)."""
    a = freq.shape[2]
    out = []
    for ai in range(a):
        acc = None
        for kk in range(freq.shape[0]):
            t = q[:, kk][:, None] * freq[kk, :, ai][None, :]
            acc = t if acc is None else acc + t
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# genotype-frequency tables
# ---------------------------------------------------------------------------

def log_hwe_table(tables: TetraTables, spec: ModelSpec, freq, freq2):
    """R: log expected (HWE) genotype-class frequencies f32[K, L, G]
    (calc_exfreq_auto/allo, poly_geno.c:1515-1670) — assembled class-group
    by class-group from the canonical digit tables (host constants)."""
    k, l, a = freq.shape
    lf1 = _slog(freq)
    lf2 = _slog(freq2) if not spec.autopoly else lf1
    out = jnp.full((k, l, tables.g_max), _NEG)
    for ci, loci, g in tables.class_loci:
        digs = tables.digits_np[ci, :g]                  # host [g, 4]
        acc = jnp.broadcast_to(
            jnp.asarray(tables.log_mult)[ci, :g][None, None, :],
            (k, len(loci), g))
        for slot in range(4):
            lf = lf1 if (spec.autopoly or slot < 2) else lf2
            # gather [K, Lc, g]: allele index digs[:, slot] per class slot
            sub = lf[:, loci, :]                         # [K, Lc, A]
            acc = acc + sub[:, :, digs[:, slot]]
        out = out.at[:, loci, :g].set(acc)
    return out


def selfing_equilibrium(tables: TetraTables, log_hwe, s):
    """log genotype-class frequencies under selfing rate s_k per pop:
    solve (I - s_k A_c) P = (1 - s_k) R batched over pops and the loci of
    each allele-count class (replaces auto_genfreq/allo_genfreq,
    poly_geno.c:1803-2304).  A column-stochastic => columns of the solution
    sum to 1 exactly (the reference's "frequencies <= 1" invariant)."""
    k, l, g_max = log_hwe.shape
    out = jnp.full((k, l, g_max), _NEG)
    for ci, loci, g in tables.class_loci:
        a = tables.self_mat[ci, :g, :g]
        eye = jnp.eye(g)
        mats = eye[None] - s[:, None, None] * a[None]        # [K, g, g]
        r = jnp.exp(log_hwe[:, loci, :g])                    # [K, Lc, g]
        sol = jax.vmap(lambda m, b: jnp.linalg.solve(m, b.T).T)(mats, r)
        p = (1.0 - s)[:, None, None] * sol
        out = out.at[:, loci, :g].set(_slog(p))
    return out


# ---------------------------------------------------------------------------
# site-level gathers
# ---------------------------------------------------------------------------

def _site_class(tables: TetraTables, data: Dataset, geno_flat):
    """class index i32[N, L] of the current ordered genotype (the
    get_index_auto/allo role, poly_geno.c:1289-1311, 1374-1394)."""
    g0, g1, g2, g3 = _split4(geno_flat)
    nm = tables.n_max
    packed = ((g0 * nm + g1) * nm + g2) * nm + g3
    return _select_or_gather(tables.lookup[tables.cls], packed)


def _table_at(geno_table_log, z0, cls_idx):
    """t f32[N, L] = geno_table_log[z0, l, cls_idx]."""
    k, l, g = geno_table_log.shape
    table_lv = jnp.transpose(geno_table_log, (1, 0, 2)).reshape(l, k * g)
    return _select_or_gather(table_lv, z0 * g + cls_idx)


def _log_mult_at(tables, cls_idx):
    return _select_or_gather(tables.log_mult[tables.cls], cls_idx)


def site_indv_loglik(tables, spec: ModelSpec, data: Dataset, freq, freq2,
                     z, geno, geno_table_log):
    """Per-individual conditional log-lik f32[N] (cal_lkd summed over
    loci).  Callers psum over loci shards."""
    return _site_loglik(tables, spec, data, freq, freq2, z, geno,
                        geno_table_log).sum(axis=1)


def _site_loglik(tables, spec, data, freq, freq2, z, geno, geno_table_log):
    """Per-site log-lik f32[N, L] (cal_lkd via calc_genofq,
    poly_geno.c:715-735, 1235-1286)."""
    cls_idx = _site_class(tables, data, geno)
    zc = _split4(z)
    gc = _split4(geno)
    same_z = (zc[0] == zc[1]) & (zc[1] == zc[2]) & (zc[2] == zc[3])
    ll_same = _table_at(geno_table_log, zc[0], cls_idx)
    ll_mix = _log_mult_at(tables, cls_idx)
    k, l, a = freq.shape
    for slot in range(4):
        f_sys = freq if (spec.autopoly or slot < 2) else freq2
        table_lv = jnp.transpose(f_sys, (1, 0, 2)).reshape(l, k * a)
        vals = _select_or_gather(table_lv, zc[slot] * a + gc[slot])
        ll_mix = ll_mix + _slog(vals)
    site = jnp.where(same_z, ll_same, ll_mix)
    return jnp.where(data.site_valid, site, 0.0)


# ---------------------------------------------------------------------------
# update kernels
# ---------------------------------------------------------------------------

def tetra_allele_counts(spec, data: Dataset, z, geno, slots):
    """f32[K, L, A] valid copies per (pop, locus, allele) over the given
    genotype slots (the counting loops of update_P_auto/allo,
    poly_geno.c:390-517)."""
    k = spec.n_pops
    l = data.n_loci
    a = data.allele_valid.shape[1]
    zc = _split4(z)
    gc = _split4(geno)
    valid = data.site_valid
    out = []
    for kk in range(k):
        per_a = []
        for ai in range(a):
            acc = jnp.zeros((l,), jnp.float32)
            for c in slots:
                m = valid & (zc[c] == kk) & (gc[c] == ai)
                acc = acc + m.astype(jnp.float32).sum(axis=0)
            per_a.append(acc)
        out.append(jnp.stack(per_a, axis=-1))
    return jnp.stack(out)                                    # [K, L, A]


def _update_p_tetra(key, spec, data: Dataset, z, geno):
    """Dirichlet-conjugate P update(s) from the latent genotype
    (update_P_auto/allo, poly_geno.c:390-517); the allo variant counts
    slots 0-1 into system 1 and 2-3 into system 2."""
    def draw(kk, slots):
        return up.dirichlet_from_counts(
            kk, tetra_allele_counts(spec, data, z, geno, slots) + 1.0,
            data.allele_valid[None])

    if spec.autopoly:
        return draw(key, range(4)), None
    k1, k2 = jax.random.split(key)
    return draw(k1, [0, 1]), draw(k2, [2, 3])


def _update_zq_tetra(key, tables, spec, data, freq, freq2, q, alpha, geno,
                     axis_name=None):
    """Per-copy Z Gibbs + Q | Z (update_ZQ, poly_geno.c:750-836), with the
    system-correct frequency per subgenome (divergence note above).
    Inverse-CDF over the static K axis — no K-trailing tensors."""
    kz, kq = jax.random.split(key)
    kz = up.shard_key(kz, axis_name)
    n, s4 = geno.shape
    l = data.n_loci
    k, _, a = freq.shape
    # copy-major layout: slots 0-1 (system 1) at columns [0, 2L),
    # slots 2-3 (system 2, allo only) at [2L, 4L)
    sys2 = jnp.arange(s4) >= 2 * l if not spec.autopoly else None
    terms = []
    for kk in range(k):
        v1 = jnp.zeros((n, s4), freq.dtype)
        for ai in range(a):
            vals = jnp.tile(freq[kk, :, ai], 4)[None]
            v1 = jnp.where(geno == ai, vals, v1)
        if spec.autopoly:
            v = v1
        else:
            v2 = jnp.zeros((n, s4), freq.dtype)
            for ai in range(a):
                vals = jnp.tile(freq2[kk, :, ai], 4)[None]
                v2 = jnp.where(geno == ai, vals, v2)
            v = jnp.where(sys2[None], v2, v1)
        terms.append(q[:, kk][:, None] * v)
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    u = jax.random.uniform(kz, (n, s4)) * total
    z = jnp.zeros((n, s4), jnp.int32)
    cum = jnp.zeros_like(total)
    for kk in range(k - 1):
        cum = cum + terms[kk]
        z = z + (u > cum).astype(jnp.int32)

    valid = jnp.tile(data.site_valid, (1, 4))
    cols = [jnp.where(valid & (z == kk), 1.0, 0.0).sum(axis=1)
            for kk in range(k)]
    qqnum = up._psum(jnp.stack(cols, axis=1), axis_name)
    q_new = up.dirichlet_from_counts(kq, qqnum + alpha)
    return z.astype(jnp.int8), q_new


def _candidate_sel(tables: TetraTables, data: Dataset, c: int):
    """For candidate index c: the 4 slot SELECTOR arrays [N, L] (indices
    0..3 into the site's distinct-allele set) from the pattern bank
    (the two/tri/tetra_allele_* tables, poly_geno.c:2440-2638)."""
    cnt = jnp.clip(data.n_distinct, 1, 4)                    # [N, L]
    sels = []
    for m in range(4):
        pat_cm = tables.patterns_np[:, c, m]                 # host [5]
        # scalar selects over the 4 cnt values (a [N, L] gather into the
        # tiny table costs ~1000x more than these fused compares)
        sel = jnp.full_like(cnt, int(pat_cm[1]))
        for v in (2, 3, 4):
            sel = jnp.where(cnt == v, int(pat_cm[v]), sel)
        sels.append(sel)
    return sels


def _sel_values(data: Dataset, sels):
    """Map slot selectors to allele values through the distinct planes."""
    dist = _split4(data.distinct)                            # 4 x [N, L]
    slots = []
    for sel in sels:
        val = jnp.zeros_like(sel)
        for j in range(4):
            val = jnp.where(sel == j, dist[j], val)
        slots.append(val)
    return slots


def _candidate_slots(tables: TetraTables, data: Dataset, c: int):
    """Slot-allele arrays of candidate c (selector routing + value map)."""
    return _sel_values(data, _candidate_sel(tables, data, c))


def _candidate_planes(tables: TetraTables, data: Dataset):
    """Precompute the static per-candidate site planes (cand_sel /
    cand_cls / cand_mult — see TetraTables): one jitted pass at build
    time replaces ~300 fused select ops PER CANDIDATE PER STEP."""
    n_cand = int(tables.n_patterns_np.max())
    nm = tables.n_max

    @jax.jit
    def build():
        sel_pl, cls_pl, mult_pl = [], [], []
        for c in range(n_cand):
            sels = _candidate_sel(tables, data, c)
            slots = _sel_values(data, sels)
            packed = (((slots[0] * nm + slots[1]) * nm + slots[2]) * nm
                      + slots[3])
            cls_idx = _select_or_gather(tables.lookup[tables.cls], packed)
            lmult = _select_or_gather(tables.log_mult[tables.cls], cls_idx)
            sel8 = (sels[0] | (sels[1] << 2) | (sels[2] << 4)
                    | (sels[3] << 6))
            sel_pl.append(sel8.astype(jnp.uint8))
            cls_pl.append(cls_idx.astype(jnp.int16))
            mult_pl.append(jnp.round(jnp.exp(lmult)).astype(jnp.uint8))
        return (jnp.stack(sel_pl), jnp.stack(cls_pl), jnp.stack(mult_pl))

    return build()


def _sample_geno(key, tables, spec, data, freq, freq2, q, geno_table_log,
                 z):
    """Gibbs update of the latent ordered genotype (update_geno,
    poly_geno.c:520-580 + choose_*, 854-1215) for every site in parallel.

    Candidate weights:
      same-z:  log table[z0, l, class(candidate)]
      mixed-z: log_mult(candidate) + sum_slots log( sum_k q_k f_sys[k, a] )
    """
    n = data.geno.shape[0]
    l = data.n_loci
    zc = _split4(z)
    same_z = (zc[0] == zc[1]) & (zc[1] == zc[2]) & (zc[2] == zc[3])
    cnt = jnp.clip(data.n_distinct, 1, 4)
    n_cand = int(tables.n_patterns_np.max())
    mix1 = _mix_per_allele(freq, q)                          # A x [N, L]
    mix2 = (_mix_per_allele(freq2, q) if not spec.autopoly else mix1)
    a = freq.shape[2]

    # number of valid candidates per site (scalar selects, not a gather)
    npat = tables.n_patterns_np
    nc = jnp.full_like(cnt, int(npat[1]))
    for v in (2, 3, 4):
        nc = jnp.where(cnt == v, int(npat[v]), nc)

    # Streaming Gumbel-argmax over the candidate bank: the categorical
    # draw keeps only a running (best value, best index) pair, so peak
    # live memory is a few [N, L] planes instead of the [N, C, L]
    # weight + gumbel stacks (C up to 12) the stacked formulation
    # materializes (update_geno, poly_geno.c:520-580).  Candidate slot
    # routing,
    # class index and multiplicity come from the STATIC precomputed
    # planes (tables.cand_*): only the weight lookups depend on the
    # sampler state, which cuts the unrolled graph (and its compile
    # time) ~2.5x vs recomputing the pattern routing per step.
    dist = _split4(data.distinct)
    best_val = jnp.full((n, l), _NEG)
    choice = jnp.zeros((n, l), jnp.int32)
    for c in range(n_cand):
        cls_idx = tables.cand_cls[c].astype(jnp.int32)
        w_same = _table_at(geno_table_log, zc[0], cls_idx)
        w_mix = jnp.log(tables.cand_mult[c].astype(jnp.float32))
        sel8 = tables.cand_sel[c].astype(jnp.int32)
        for m in range(4):
            sel_m = (sel8 >> (2 * m)) & 3
            av = jnp.zeros((n, l), jnp.int32)
            for j in range(4):
                av = jnp.where(sel_m == j, dist[j], av)
            mix = mix1 if (spec.autopoly or m < 2) else mix2
            val = jnp.zeros((n, l), jnp.float32)
            for ai in range(a):
                val = jnp.where(av == ai, mix[ai], val)
            w_mix = w_mix + _slog(val)
        w = jnp.where(same_z, w_same, w_mix)
        gumbel = -jnp.log(-jnp.log(jax.random.uniform(
            jax.random.fold_in(key, c), (n, l), minval=1e-12, maxval=1.0)))
        v = jnp.where(c < nc, w + gumbel, _NEG)
        take = v > best_val
        best_val = jnp.where(take, v, best_val)
        choice = jnp.where(take, c, choice)

    return _reconstruct_geno(tables, data, choice, n_cand)


def _reconstruct_geno(tables, data, choice, n_cand):
    """Chosen candidate index [N, L] -> ordered genotype i8[N, 4L]: route
    the chosen candidate's packed selectors once, then map selectors to
    allele values through the distinct planes."""
    n, l = choice.shape
    dist = _split4(data.distinct)
    sel_ch = jnp.zeros((n, l), jnp.int32)
    for c in range(n_cand):
        sel_ch = jnp.where(choice == c,
                           tables.cand_sel[c].astype(jnp.int32), sel_ch)
    geno_slots = []
    for m in range(4):
        sel_m = (sel_ch >> (2 * m)) & 3
        av = jnp.zeros((n, l), jnp.int32)
        for j in range(4):
            av = jnp.where(sel_m == j, dist[j], av)
        geno_slots.append(av)
    return jnp.concatenate(geno_slots, axis=1).astype(jnp.int8)


# ---------------------------------------------------------------------------
# init + step
# ---------------------------------------------------------------------------

def init_tetra_state(key, spec: ModelSpec, data: Dataset, init_rates=None,
                     axis_name=None, tables=None) -> McmcState:
    """Initial draw (initial_geno, poly_geno.c:316-369: uniform ordering;
    z uniform; S from file or U(0,1); alpha ~ U[0,10]).  Under loci
    sharding (``axis_name``) the site-level draws (z, geno) are
    shard-folded, the q counts psummed, and the replicated scalars
    (alpha, S) use the unfolded key; ``tables`` must then be prebuilt
    from a concrete shard-local view (the class-uniform layout makes it
    valid for every shard)."""
    if tables is None:
        tables = build_tables(spec, data)
    n = data.geno.shape[0]
    l = data.n_loci
    k = spec.n_pops
    a = data.allele_valid.shape[1]
    kz, kq, kal, ks, kg = jax.random.split(key, 5)
    kz = up.shard_key(kz, axis_name)
    kg = up.shard_key(kg, axis_name)

    cnt = jnp.clip(data.n_distinct, 1, 4)
    n_cand = int(tables.n_patterns_np.max())
    w = jnp.where(
        jnp.arange(n_cand)[None, :, None]
        < jnp.asarray(tables.n_patterns_np)[cnt][:, None, :], 0.0, _NEG)
    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(kg, w.shape, minval=1e-12, maxval=1.0)))
    choice = jnp.argmax(w + gumbel, axis=1)                  # [N, L]
    geno_slots = []
    for m in range(4):
        val = jnp.zeros((n, l), jnp.int32)
        for c in range(n_cand):
            slots = _candidate_slots(tables, data, c)
            val = jnp.where(choice == c, slots[m], val)
        geno_slots.append(val)
    geno = jnp.concatenate(geno_slots, axis=1).astype(jnp.int8)

    z = jax.random.randint(kz, (n, l * 4), 0, k).astype(jnp.int8)
    valid = jnp.tile(data.site_valid, (1, 4))
    cols = [jnp.where(valid & (z == kk), 1.0, 0.0).sum(axis=1)
            for kk in range(k)]
    alpha = jax.random.uniform(kal) * spec.alpha_prior_max
    counts = up._psum(jnp.stack(cols, axis=1), axis_name)
    g = jax.random.gamma(kq, counts + alpha)
    q = g / jnp.maximum(g.sum(-1, keepdims=True), _EPS)

    if init_rates is None:
        rates = jax.random.uniform(ks, (k,))
    else:
        rates = jnp.asarray(init_rates, jnp.float32).reshape(k)

    valid_f = data.allele_valid.astype(jnp.float32)
    freq0 = valid_f / jnp.maximum(valid_f.sum(-1, keepdims=True), 1.0)
    freq0 = jnp.broadcast_to(freq0[None], (k, l, a)).astype(jnp.float32)

    return McmcState(
        freq=freq0, z=z, zz=jnp.zeros((0,), jnp.int32), q=q, alpha=alpha,
        rates=rates, ais_state=_dt_stat(rates).astype(jnp.int32),
        gen=jnp.zeros((0,), jnp.int32),
        loglik_indv=jnp.zeros((n,), jnp.float32),
        loglik_total=jnp.zeros((), jnp.float32),
        dpm_values=jnp.zeros((0,), jnp.float32),
        dpm_counts=jnp.zeros((0,), jnp.int32),
        dpm_assign=jnp.zeros((0,), jnp.int32),
        prior_mu=jnp.asarray(spec.priors.normal_mu0, jnp.float32),
        prior_sigma2=jnp.asarray(spec.priors.normal_sigmasqr0, jnp.float32),
        freq2=freq0, geno=geno,
        loglik_marg=jnp.zeros((n,), jnp.float32),
    )


def retable_candidates(tables: TetraTables, data: Dataset) -> TetraTables:
    """Rebuild the site-dependent candidate planes (cand_sel/cls/mult/nc)
    from ``data`` — pure jnp ops, so this works on TRACED shard-local
    panels inside a shard_map (the class-level fields of ``tables`` are
    shard-invariant under the class-uniform layout,
    parallel/loci_shard.py:tetra_shard_plan)."""
    sel, cls_p, mult = _candidate_planes(tables, data)
    cnt = jnp.clip(data.n_distinct, 1, 4)
    npat = tables.n_patterns_np
    nc = jnp.full(cnt.shape, int(npat[1]), jnp.int32)
    for v in (2, 3, 4):
        nc = jnp.where(cnt == v, int(npat[v]), nc)
    return tables._replace(cand_sel=sel, cand_cls=cls_p, cand_mult=mult,
                           cand_nc=nc.astype(jnp.uint8))


def build_tetra_step(spec: ModelSpec, data: Dataset, axis_name=None,
                     tables=None):
    """(step_core, add_loglik) for one tetraploid sweep (the step body of
    mcmc_POP_tetra_selfing, poly_geno.c:98-136): P (+P2), exfreq, S, ZQ,
    geno; the likelihood pass (cal_lkd, poly_geno.c:715) is split out so
    the chain driver evaluates it only on stored/reported steps — the same
    deferral the diploid engine gets from build_step_parts (at the default
    thinning of 10 this removes ~90% of the cal_lkd passes).

    Loci sharding (``axis_name`` + prebuilt ``tables``): the panel is the
    device-local class-uniform block; site draws (P, z, geno) are
    shard-local with shard-folded keys, and the only collectives are the
    psums of the per-individual pop counts [N, K], the per-pop S MH
    log-ratio [K], and the per-individual log-liks [N] — the same
    auditable set as the diploid path (parallel/loci_shard.py)."""
    if data.distinct is None:
        raise ValueError("tetraploid step needs Dataset.distinct / "
                         "n_distinct (load with ploid=4)")
    if tables is None:
        tables = build_tables(spec, data)
    elif tables.cand_sel is None or axis_name is not None:
        # runtime-argument panel (the driver's path — the panel must not
        # become a compiled-in constant) or a shard-local traced view:
        # rebuild the site-dependent candidate planes in-trace
        tables = retable_candidates(tables, data)

    def add_loglik(state: McmcState) -> McmcState:
        # the genotype-class table is a pure function of (freq, freq2, S):
        # rebuilding it here is O(K L G) + the per-class batched solves —
        # cheap next to the [N, L] site pass it feeds
        log_hwe = log_hwe_table(tables, spec, state.freq, state.freq2)
        table = selfing_equilibrium(tables, log_hwe, state.rates)
        indv = up._psum(
            site_indv_loglik(tables, spec, data, state.freq, state.freq2,
                             state.z, state.geno, table), axis_name)
        return state._replace(loglik_indv=indv, loglik_total=indv.sum())

    def step(state: McmcState, key) -> McmcState:
        kp, ks, kz, kg, ka = jax.random.split(key, 5)
        # P draws are per-locus local; S/alpha/Q draws must be replicated
        kp = up.shard_key(kp, axis_name)

        freq, freq2 = _update_p_tetra(kp, spec, data, state.z, state.geno)
        if freq2 is None:
            freq2 = state.freq2
        state = state._replace(freq=freq, freq2=freq2)

        log_hwe = log_hwe_table(tables, spec, freq, freq2)

        # --- S update: per-pop MH with full-table rebuild --------------
        # spec.s_subsweeps > 1 runs extra inner MH sweeps: each costs one
        # batched equilibrium solve + one class-table site lookup (cheap
        # next to the genotype move), and the honest per-chain ESS showed
        # the single-sweep S chain at tau ~ 30 (round 5) — the same lever
        # as the diploid path.  1 reproduces the reference's schedule
        # (update_S_POP once per step, poly_geno.c:98-136).
        tab_cur = selfing_equilibrium(tables, log_hwe, state.rates)
        rates = state.rates
        ais = state.ais_state
        n_sweeps = max(1, spec.s_subsweeps)
        # the current per-site values (ll_cur) are carried so later
        # sweeps reuse them
        cls_idx = _site_class(tables, data, state.geno)
        zc = _split4(state.z)
        same_z = ((zc[0] == zc[1]) & (zc[1] == zc[2])
                  & (zc[2] == zc[3]))
        s_mask = same_z & data.site_valid
        ll_cur = _table_at(tab_cur, zc[0], cls_idx)
        for j in range(n_sweeps):
            kacc, kprop = jax.random.split(jax.random.fold_in(ks, j))
            if spec.back_refl == 1:
                prop = up.propose_back_reflection(kprop, rates,
                                                  spec.mh_step_s)
                prop_states = ais
                log_hast = jnp.zeros_like(rates)
            else:
                prop, prop_states, log_hast = \
                    up.propose_adaptive_independence(kprop, rates, ais)
            tab_prop = selfing_equilibrium(tables, log_hwe, prop)
            ll_prop = _table_at(tab_prop, zc[0], cls_idx)
            diff = jnp.where(s_mask, ll_prop - ll_cur, 0.0)
            delta = up._psum(
                jnp.stack([jnp.where(zc[0] == kk, diff, 0.0).sum()
                           for kk in range(spec.n_pops)]), axis_name)
            u = jax.random.uniform(kacc, (spec.n_pops,), minval=_EPS)
            accept = jnp.log(u) < delta + log_hast
            rates = jnp.where(accept, prop, rates)
            ais = jnp.where(accept, prop_states, ais)
            # the accepted table/site values are per-pop selects of the
            # two already-solved tables — no third equilibrium solve (the
            # reference re-solves via move_genofreq, poly_geno.c:737)
            tab_cur = jnp.where(accept[:, None, None], tab_prop, tab_cur)
            acc_site = jnp.zeros(ll_cur.shape, jnp.bool_)
            for kk in range(spec.n_pops):
                acc_site = acc_site | ((zc[0] == kk) & accept[kk])
            ll_cur = jnp.where(acc_site, ll_prop, ll_cur)
        state = state._replace(rates=rates, ais_state=ais)
        geno_table = tab_cur

        # --- Z, Q ------------------------------------------------------
        z, q = _update_zq_tetra(kz, tables, spec, data, freq, freq2,
                                state.q, state.alpha, state.geno, axis_name)
        state = state._replace(z=z, q=q)

        # --- latent genotype ordering (site-local; shard-folded key) ---
        geno = _sample_geno(up.shard_key(kg, axis_name), tables, spec,
                            data, freq, freq2, q, geno_table, z)
        state = state._replace(geno=geno)

        # --- alpha ----------------------------------------------------
        alpha = up.update_alpha(ka, spec, q, state.alpha)
        return state._replace(alpha=alpha)

    return step, add_loglik
