"""Fused Pallas (Triton route) site pass for the diploid step (modes 1-5).

The XLA formulation of one MCMC sweep re-reads the site tensors in every
update and materializes several f32 [N, S] planes per pass.  The sweep has
two sequence points that need a pass over the sites:

  1. given the fresh P and the old Q: Z-Gibbs sample + per-individual pop
     counts + the [K, L, A] allele-pop counts of the fresh z (the next
     step's P update) + the G/F MH log-ratio at the fresh z
  2. on stored steps only: the panel log-likelihood (cal_lkh)

Each is one kernel here, reading the int8 site planes once and keeping the
intermediates in registers.  Reference parity: the kernels compute the
update equations of update_P's count loop (mcmc.c:815-845), update_ZQ
(mcmc.c:1122-1199), update_G's likelihood ratio via log_ld_indv
(mcmc.c:1053-1091, 1726-1773) and cal_lkh (mcmc.c:1916-1942); fed the same
uniforms (``u=``) they reproduce the XLA formulas (tests/test_fused_step.py).

Grid and reductions.  One program owns a [bg, bl] tile of (individuals,
loci) and walks it in [bn, bl] chunks with an in-kernel loop.  Programs run
in parallel and in no order, so nothing carries across the grid:

  * per-individual sums (pop counts, log-likelihood columns) are written as
    per-L-block partials [n_l_blocks, Np, C] and reduced by XLA;
  * the [K*A, L] allele-pop counts accumulate over the chunk loop in
    registers and are written as per-row-group partials [n_groups, KA, Lp].

The site planes are read unpadded through masked loads (copy-major
[N, 2L] layout, data/dataset.py); only the small q / freq / column operands
are padded to the block grid.

Random bits.  A counter-based hash keyed on the two seed words and the
global (individual, copy, locus) index, so a draw never depends on the
block shape (:func:`site_uniform`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_LOG2 = 0.6931471805599453
_EPS = 1e-30

# Default tile: bg rows per program, walked in chunks of bn rows x bl loci.
# A [16, 32] f32 plane is 8 values per thread at 2 warps, which keeps the
# ~20 live planes of the biallelic sampling path inside the register file,
# and a 32-wide chunk keeps the per-individual row sums short.  Chosen by
# an on-card sweep of (bg, bn, bl, warps) at the flagship panel (PERF.md).
DEFAULT_BLOCK = (256, 16, 32)
NUM_WARPS = 2
NUM_STAGES = 2

# Widest (pop x allele) grid the kernel takes: the [K*A, bl] count
# accumulator lives in registers across the chunk loop (K*A * bl / 64
# threads = 32 f32 registers a thread at the limit).
MAX_POP_ALLELE_CELLS = 64


def seed_words(key) -> jnp.ndarray:
    """The raw 32-bit words of a typed PRNG key, as i32[W]."""
    kd = jax.random.key_data(key)
    return jax.lax.bitcast_convert_type(kd, jnp.int32).reshape(-1)


def _seed_pair(seed) -> jnp.ndarray:
    """Any i32 scalar / i32[W] seed folded to exactly two words (XOR of the
    even and of the odd words)."""
    w = jnp.atleast_1d(jnp.asarray(seed, jnp.int32)).reshape(-1)
    w = jnp.pad(w, (0, (-w.shape[0]) % 2)).reshape(-1, 2)
    out = w[0]
    for r in range(1, w.shape[0]):
        out = out ^ w[r]
    return out


# ---------------------------------------------------------------------------
# Counter-based random bits (plain jnp: the same code runs in the kernel and
# on the host, which is what the tests check)
# ---------------------------------------------------------------------------

def mix32(x):
    """lowbias32 integer finalizer (bijective on uint32)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def row_keys(s0, s1, rows, copy):
    """Per-(individual, copy) stream key; ``rows`` i32 global indices."""
    r = rows.astype(jnp.uint32) * jnp.uint32(2) + jnp.uint32(copy)
    return mix32(mix32(r ^ s0.astype(jnp.uint32)) + s1.astype(jnp.uint32))


def col_keys(s1, cols):
    """Per-locus key; ``cols`` i32 global locus indices."""
    c = cols.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
    return mix32(c ^ s1.astype(jnp.uint32))


def site_uniform(rk, ck):
    """U[0, 1) at 24-bit resolution for every (row key, column key) pair:
    rk [R], ck [C] -> f32[R, C]."""
    bits = mix32(rk[:, None] ^ ck[None, :])
    return (bits >> 8).astype(jnp.int32).astype(jnp.float32) * (1.0 / (1 << 24))


def site_uniforms(seed, n, l):
    """The uniform planes the sampling pass draws with ``seed``, as
    f32[N, 2L] (copy-major) — the host-side twin of the in-kernel draw."""
    s0, s1 = _seed_pair(seed)
    rows = jnp.arange(n, dtype=jnp.int32)
    ck = col_keys(s1, jnp.arange(l, dtype=jnp.int32))
    return jnp.concatenate([site_uniform(row_keys(s0, s1, rows, c), ck)
                            for c in (0, 1)], axis=1)


def _log(x):
    return jnp.log(jnp.maximum(x, _EPS))


def _pow2(x):
    return 1 << max(0, int(x) - 1).bit_length()


def _pass_flags(ll_kind, structure, sample):
    """(need_hom, need_zin, need_colv) — which optional operand groups the
    per-site pass consumes for the given log-likelihood family.

    When sampling, every z-conditioned family evaluates at the FRESHLY
    drawn z, still in registers — the sweep order is "Z then G/F | z" (a
    Gibbs-scan permutation of the reference's G/F-then-Z order with the
    same stationary distribution), which drops the two carried-z input
    planes from the hot pass.  Stored-step passes (sample=False) evaluate
    at the carried z planes."""
    need_hom = ll_kind in ("gen", "gendiff", "find", "fpop")
    need_zin = (not sample) and (
        (ll_kind in ("gen", "gendiff") and structure)
        or ll_kind in ("find", "fpop", "mode1"))
    need_colv = ll_kind in ("gen", "gendiff", "find")
    return need_hom, need_zin, need_colv


def _n_out(ll_kind, full_ll, n_col, k):
    if ll_kind == "mode1" or full_ll or ll_kind in ("gendiff", "find"):
        return 1
    if ll_kind == "fpop":
        return k
    return n_col


# ---------------------------------------------------------------------------
# The kernel: one [bg, bl] tile, walked in [bn, bl] chunks
# ---------------------------------------------------------------------------

def _chunk(r, *, n, l, k, a, n_col, sample, ll_kind, structure, full_ll,
           packed, inject_u, rows0, col0, bn, bl, frows, s0, s1, ck):
    """Everything the pass computes for one [bn, bl] chunk.  Returns
    (per-row output columns dict, per-(pop, allele) column sums list)."""
    need_hom, need_zin, _ = _pass_flags(ll_kind, structure, sample)
    rows = rows0 + jax.lax.broadcasted_iota(jnp.int32, (bn,), 0)
    cols = col0 + jax.lax.broadcasted_iota(jnp.int32, (bl,), 0)
    m2 = (rows < n)[:, None] & (cols < l)[None, :]
    rsl, csl = pl.ds(rows0, bn), pl.ds(col0, bl)
    csl1 = pl.ds(l + col0, bl)

    def site(ref, second=False, other=0):
        return plt.load(ref.at[rsl, csl1 if second else csl], mask=m2,
                        other=other)

    g0f = g1f = hom = None
    if packed:
        # one int8 plane carries the whole site (dataset.bits2)
        si = site(r["bits2"]).astype(jnp.int32)
        g0 = si & 1
        g1 = (si >> 1) & 1
        g0f = g0.astype(jnp.float32)
        g1f = g1.astype(jnp.float32)
        valid = (si & 4) != 0
        if need_hom:
            hom = (g0f - g1f) == 0.0
    else:
        g0 = site(r["geno"]).astype(jnp.int32)
        g1 = site(r["geno"], True).astype(jnp.int32)
        valid = site(r["valid"]).astype(jnp.int32) != 0
        if need_hom:
            hom = site(r["hom"]).astype(jnp.int32) != 0
    vf = valid.astype(jnp.float32)
    z0_in = z1_in = None
    if need_zin:
        z0_in = site(r["z_in"]).astype(jnp.int32)
        z1_in = site(r["z_in"], True).astype(jnp.int32)
    qcols = [r["q"][rsl, kk][:, None] for kk in range(k)]

    a2 = a == 2
    if a2:
        f0r = [frows[kk * 2][None, :] for kk in range(k)]
        dr = [frows[kk * 2 + 1][None, :] - f0r[kk] for kk in range(k)]
        if g0f is None:
            g0f = (g0 == 1).astype(jnp.float32)
            g1f = (g1 == 1).astype(jnp.float32)

        def sel_rows(rws, zc):
            out = rws[0]
            for kk in range(1, k):
                out = jnp.where(zc == kk, rws[kk], out)
            return out

        def at_z2(zc, gf):
            return sel_rows(f0r, zc) + sel_rows(dr, zc) * gf

        need_mix = sample or (ll_kind in ("gen", "gendiff") and not structure)
        A = B = None
        if need_mix:
            # w_k(g) = f0_k + d_k g is affine in the allele bit, so the
            # categorical CDF prefixes are cum_j = A_j + B_j g
            cumA, cumB = qcols[0] * f0r[0], qcols[0] * dr[0]
            A, B = [cumA], [cumB]
            for kk in range(1, k):
                cumA = cumA + qcols[kk] * f0r[kk]
                cumB = cumB + qcols[kk] * dr[kk]
                A.append(cumA)
                B.append(cumB)
    else:
        def w_of(gc):
            ws = []
            for kk in range(k):
                w = jnp.zeros(gc.shape, jnp.float32)
                for ai in range(a):
                    w = jnp.where(gc == ai, frows[kk * a + ai][None, :], w)
                ws.append(w)
            return ws

        w0 = w_of(g0)
        w1 = w_of(g1)

    def uniform(copy):
        if inject_u:
            return site(r["u"], copy == 1, 0.5)
        return site_uniform(row_keys(s0, s1, rows, copy), ck)

    row_out = {}
    cnt_cols = []
    z0 = z1 = None
    ind0 = ind1 = tot0 = tot1 = z0s = z1s = None
    if sample:
        if a2:
            def draw2(gf, u01):
                tot = A[-1] + B[-1] * gf
                ut = u01 * tot
                return [(ut > A[jj] + B[jj] * gf).astype(jnp.float32)
                        for jj in range(k - 1)], tot

            ind0, tot0 = draw2(g0f, uniform(0))
            ind1, tot1 = draw2(g1f, uniform(1))

            def zsum(indf):
                s = jnp.zeros(g0f.shape, jnp.float32)
                for t in indf:
                    s = s + t
                return s

            z0s, z1s = zsum(ind0), zsum(ind1)
            plt.store(r["z"].at[rsl, csl], z0s.astype(jnp.int8), mask=m2)
            plt.store(r["z"].at[rsl, csl1], z1s.astype(jnp.int8), mask=m2)

            # counting straight off the draw indicators: (z == k) =
            # ind_{k-1} - ind_k, so the per-pop masses never materialize
            # (update_ZQ's qq_num, mcmc.c:1180-1189; update_P's counting
            # loop, mcmc.c:815-845)
            rv = vf.sum(axis=1)
            iv0 = [x * vf for x in ind0]
            iv1 = [x * vf for x in ind1]
            rs = [(x.sum(axis=1) + y.sum(axis=1)) for x, y in zip(iv0, iv1)]
            qq = []
            for kk in range(k):
                hi = 2.0 * rv if kk == 0 else rs[kk - 1]
                lo = rs[kk] if kk < k - 1 else 0.0
                qq.append(hi - lo)
            row_out["qq"] = qq

            def colsum(x):
                return x.sum(axis=0)

            s_prev = 2.0 * colsum(vf)
            t_prev = colsum(vf * (g0f + g1f))
            for kk in range(k):
                if kk < k - 1:
                    s_k = colsum(iv0[kk] + iv1[kk])
                    t_k = colsum(iv0[kk] * g0f + iv1[kk] * g1f)
                else:
                    s_k = t_k = 0.0
                ones = t_prev - t_k
                cnt_cols += [(s_prev - s_k) - ones, ones]
                s_prev, t_prev = s_k, t_k
        else:
            # z_c ~ Cat_k(q_k * w_c_k) by inverse CDF (update_ZQ,
            # mcmc.c:1146)
            def draw(ws, u01):
                terms = [qcols[kk] * ws[kk] for kk in range(k)]
                total = terms[0]
                for t in terms[1:]:
                    total = total + t
                uu = u01 * total
                zc = jnp.zeros(total.shape, jnp.int32)
                cum = jnp.zeros_like(total)
                for kk in range(k - 1):
                    cum = cum + terms[kk]
                    zc = zc + (uu > cum).astype(jnp.int32)
                return zc

            z0 = draw(w0, uniform(0))
            z1 = draw(w1, uniform(1))
            plt.store(r["z"].at[rsl, csl], z0.astype(jnp.int8), mask=m2)
            plt.store(r["z"].at[rsl, csl1], z1.astype(jnp.int8), mask=m2)
            qq = []
            for kk in range(k):
                m0 = (z0 == kk).astype(jnp.float32) * vf
                m1 = (z1 == kk).astype(jnp.float32) * vf
                qq.append((m0 + m1).sum(axis=1))
                for ai in range(a):
                    cnt_cols.append(
                        (m0 * (g0 == ai).astype(jnp.float32)
                         + m1 * (g1 == ai).astype(jnp.float32)).sum(axis=0))
            row_out["qq"] = qq

    if ll_kind is None:
        return row_out, cnt_cols

    def at_z(ws, zc):
        p = ws[0]
        for kk in range(1, k):
            p = jnp.where(zc == kk, ws[kk], p)
        return p

    def at_fresh2(indf, gf):
        """w at the fresh z from the draw indicators (telescoping rows)."""
        f0z, dz = f0r[0], dr[0]
        for jj in range(k - 1):
            f0z = f0z + indf[jj] * (f0r[jj + 1] - f0r[jj])
            dz = dz + indf[jj] * (dr[jj + 1] - dr[jj])
        return f0z + dz * gf

    def cond_p(copy):
        """w of the given copy at its conditioning z — the fresh draw when
        sampling, else the carried z plane."""
        gf = g0f if copy == 0 else g1f
        if sample:
            if a2:
                return at_fresh2(ind0 if copy == 0 else ind1, gf)
            return at_z(w0 if copy == 0 else w1, z0 if copy == 0 else z1)
        if a2:
            return at_z2(z0_in if copy == 0 else z1_in, gf)
        return at_z(w0 if copy == 0 else w1, z0_in if copy == 0 else z1_in)

    def cond_same():
        if sample:
            return ((z0s - z1s) == 0.0) if a2 else ((z0 - z1) == 0)
        return (z0_in - z1_in) == 0

    def colv(c):
        return r["colv"][rsl, c][:, None]

    def mixture(copy):
        """Expectation-way per-copy probability sum_k q_k w_k."""
        if a2:
            tot = tot0 if copy == 0 else tot1
            if tot is not None:
                return tot
            return A[-1] + B[-1] * (g0f if copy == 0 else g1f)
        ws = w0 if copy == 0 else w1
        p = qcols[0] * ws[0]
        for kk in range(1, k):
            p = p + qcols[kk] * ws[kk]
        return p

    if ll_kind == "mode1":
        # cal_lkh at z (log_ld_noselfing_indv, mcmc.c:1869-1890)
        het_f = ((g0 - g1) != 0).astype(jnp.float32)
        s = _log(cond_p(0)) + _log(cond_p(1)) + het_f * _LOG2
        row_out["ll"] = [(s * vf).sum(axis=1)]
        return row_out, cnt_cols

    if ll_kind == "gendiff":
        # single-column G MH log-ratio (update_G, mcmc.c:1053-1091): with
        # gf_hom = p0 (1 - (1-p0) w) and gf_het = 2 p0 p1 w (genofreq,
        # mcmc.c:1683-1703) the p0 / 2 p0 p1 factors cancel — het sites
        # give log(w_p / w_c), only hom same-z sites need a per-site log
        if structure:
            p0 = cond_p(0)
            m = cond_same() & valid
        else:
            p0 = mixture(0)
            m = valid
        mh = (m & hom).astype(jnp.float32)
        mt = (m & jnp.logical_not(hom)).astype(jnp.float32)
        wc, wp = colv(0), colv(1)
        q1 = 1.0 - p0
        ratio = (jnp.maximum(1.0 - q1 * wp, _EPS)
                 / jnp.maximum(1.0 - q1 * wc, _EPS))
        dh = _log(r["colv"][rsl, 1]) - _log(r["colv"][rsl, 0])
        row_out["ll"] = [(jnp.log(ratio) * mh).sum(axis=1)
                         + dh * mt.sum(axis=1)]
        return row_out, cnt_cols

    if ll_kind == "gen":
        # selfing-generation columns; colv = 2^{1-g}
        if structure:
            p0, p1 = cond_p(0), cond_p(1)
            same = cond_same()
            hom_f = hom.astype(jnp.float32)
            indep = _log(p0) + _log(p1) + (1.0 - hom_f) * _LOG2
        else:
            p0, p1 = mixture(0), mixture(1)
        outs = []
        for gcol in range(n_col):
            wg = colv(gcol)
            gf = jnp.where(hom, p0 * p0 + p0 * (1.0 - p0) * (1.0 - wg),
                           2.0 * p0 * p1 * wg)
            s = _log(gf)
            if structure:
                s = jnp.where(same, s, indep)
            outs.append((s * vf).sum(axis=1))
        row_out["ll"] = outs
        return row_out, cnt_cols

    # inbreeding F families ("find" / "fpop")
    p0 = cond_p(0)
    same = cond_same()
    hom_f = hom.astype(jnp.float32)
    same_f = same.astype(jnp.float32)

    def gf_log(f, p1):
        return _log(jnp.where(hom, p0 * p0 * (1.0 - f) + p0 * f,
                              2.0 * p0 * p1 * (1.0 - f)))

    def f_ratio_log(f0, f1):
        """log gf(f1) - log gf(f0) with the p0 / 2 p0 p1 factors cancelled."""
        num = jnp.where(hom, p0 * (1.0 - f1) + f1, 1.0 - f1)
        den = jnp.where(hom, p0 * (1.0 - f0) + f0, 1.0 - f0)
        return jnp.log(jnp.maximum(num, _EPS) / jnp.maximum(den, _EPS))

    if ll_kind == "find":
        if full_ll:
            p1 = cond_p(1)
            indep = _log(p0) + _log(p1) + (1.0 - hom_f) * _LOG2
            s = jnp.where(same, gf_log(colv(0), p1), indep)
            row_out["ll"] = [(s * vf).sum(axis=1)]
        else:
            d = f_ratio_log(colv(0), colv(1))
            row_out["ll"] = [(d * same_f * vf).sum(axis=1)]
        return row_out, cnt_cols

    # "fpop": f = fvals[z0, c] at the conditioning z
    fv = r["fvals"]
    zc0 = (z0 if not a2 else z0s.astype(jnp.int32)) if sample else z0_in

    def f_at_z0(c):
        f = jnp.full(p0.shape, fv[0, c])
        for kk in range(1, k):
            f = jnp.where(zc0 == kk, fv[kk, c], f)
        return f

    if full_ll:
        p1 = cond_p(1)
        indep = _log(p0) + _log(p1) + (1.0 - hom_f) * _LOG2
        s = jnp.where(same, gf_log(f_at_z0(0), p1), indep)
        row_out["ll"] = [(s * vf).sum(axis=1)]
    else:
        d = f_ratio_log(f_at_z0(0), f_at_z0(1)) * same_f * vf
        row_out["ll"] = [(d * (zc0 == kk).astype(jnp.float32)).sum(axis=1)
                         for kk in range(k)]
    return row_out, cnt_cols


def _site_kernel(*refs, in_names, out_names, n, l, k, a, bg, bn, bl, n_col,
                 sample, ll_kind, structure, full_ll, packed, inject_u):
    r = dict(zip(in_names + out_names, refs))
    g = pl.program_id(0)
    j = pl.program_id(1)
    col0 = j * bl
    frows = [r["freq"][rr, pl.ds(col0, bl)] for rr in range(k * a)]
    s0 = r["seed"][0]
    s1 = r["seed"][1]
    ck = None
    if sample and not inject_u:
        ck = col_keys(s1, col0 + jax.lax.broadcasted_iota(jnp.int32,
                                                          (bl,), 0))
    kw = dict(n=n, l=l, k=k, a=a, n_col=n_col, sample=sample,
              ll_kind=ll_kind, structure=structure, full_ll=full_ll,
              packed=packed, inject_u=inject_u, col0=col0, bn=bn, bl=bl,
              frows=frows, s0=s0, s1=s1, ck=ck)
    n_cnt = k * a if sample else 0

    def put_rows(name, cols, rows0):
        """Store per-row column vectors into the [.., Np, C] partial."""
        ref = r[name]
        width = ref.shape[-1]
        lane = jax.lax.broadcasted_iota(jnp.int32, (bn, width), 1)
        tile = jnp.zeros((bn, width), jnp.float32)
        for c, v in enumerate(cols):
            tile = jnp.where(lane == c, v[:, None], tile)
        ref[j, pl.ds(rows0, bn), :] = tile

    def body(c, acc):
        rows0 = g * bg + c * bn
        row_out, cnt_cols = _chunk(r, rows0=rows0, **kw)
        if "qq" in row_out:
            put_rows("qq", row_out["qq"], rows0)
        if "ll" in row_out:
            put_rows("ll", row_out["ll"], rows0)
        return tuple(x + y for x, y in zip(acc, cnt_cols))

    acc0 = tuple(jnp.zeros((bl,), jnp.float32) for _ in range(n_cnt))
    acc = jax.lax.fori_loop(0, bg // bn, body, acc0)
    for rr, v in enumerate(acc):
        r["cnt"][g, rr, pl.ds(col0, bl)] = v


def _site_pass(seed, q, freq, geno, site_valid, hom, z_in, colv, fvals, u,
               *, sample, ll_kind, n_col, structure, full_ll, interpret,
               bits2=None, block=None):
    n, l = site_valid.shape
    k, _, a = freq.shape
    bg, bn, bl = block or DEFAULT_BLOCK
    bg = min(bg, max(bn, _pow2(n)))
    bl = min(bl, max(16, _pow2(l)))
    n_groups, n_lb = -(-n // bg), -(-l // bl)
    np_, lp = n_groups * bg, n_lb * bl
    need_hom, need_zin, need_colv = _pass_flags(ll_kind, structure, sample)
    packed = bits2 is not None and a == 2
    inject_u = u is not None
    kp = _pow2(k)

    names, ops = ["seed", "q", "freq"], [
        _seed_pair(seed),
        jnp.pad(q.astype(jnp.float32), ((0, np_ - n), (0, kp - k))),
        jnp.pad(jnp.transpose(freq, (0, 2, 1)).reshape(k * a, l),
                ((0, 0), (0, lp - l)))]
    if packed:
        names.append("bits2")
        ops.append(bits2)
    else:
        names += ["geno", "valid"]
        ops += [geno, site_valid]
        if need_hom:
            names.append("hom")
            ops.append(hom)
    if need_zin:
        names.append("z_in")
        ops.append(z_in)
    if need_colv:
        names.append("colv")
        ops.append(jnp.pad(colv.astype(jnp.float32),
                           ((0, np_ - n), (0, _pow2(n_col) - n_col))))
    if ll_kind == "fpop":
        names.append("fvals")
        ops.append(jnp.pad(jnp.asarray(fvals, jnp.float32),
                           ((0, kp - k), (0, _pow2(n_col) - n_col))))
    if inject_u:
        names.append("u")
        ops.append(u.astype(jnp.float32))

    n_out = _n_out(ll_kind, full_ll, n_col, k) if ll_kind else 0
    out_names, out_shapes = [], []
    if sample:
        out_names += ["z", "qq", "cnt"]
        out_shapes += [jax.ShapeDtypeStruct((n, 2 * l), jnp.int8),
                       jax.ShapeDtypeStruct((n_lb, np_, kp), jnp.float32),
                       jax.ShapeDtypeStruct((n_groups, k * a, lp),
                                            jnp.float32)]
    if ll_kind is not None:
        out_names.append("ll")
        out_shapes.append(jax.ShapeDtypeStruct((n_lb, np_, _pow2(n_out)),
                                               jnp.float32))

    kernel = functools.partial(
        _site_kernel, in_names=tuple(names), out_names=tuple(out_names),
        n=n, l=l, k=k, a=a, bg=bg, bn=bn, bl=bl, n_col=n_col,
        sample=sample, ll_kind=ll_kind, structure=structure,
        full_ll=full_ll, packed=packed, inject_u=inject_u)
    outs = pl.pallas_call(
        kernel, grid=(n_groups, n_lb), out_shape=tuple(out_shapes),
        backend="triton", interpret=interpret,
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        name=f"site_pass_{ll_kind or 'sample'}",
    )(*ops)
    o = dict(zip(out_names, outs))
    res = {}
    if sample:
        res["z"] = o["z"]
        res["qqnum"] = o["qq"].sum(axis=0)[:n, :k]
        res["zcounts"] = (o["cnt"].sum(axis=0)[:, :l].reshape(k, a, l)
                          .transpose(0, 2, 1))             # [K, L, A]
    if ll_kind is not None:
        res["ll"] = o["ll"].sum(axis=0)[:n, :n_out]
    return res


_STATIC = ("interpret", "block")


@functools.partial(jax.jit, static_argnames=("structure",) + _STATIC)
def zq_gen_pass(seed, q, freq, geno, site_valid, hom, z_old, wg_pair, *,
                structure, interpret=False, u=None, bits2=None, block=None):
    """Sample z, count per-individual pops, and compute the G log-likelihood
    at the current and proposed generation counts.

    wg_pair f32[N, 2] = 2^{1-g} for (g_cur, g_prop).
    Returns (z int8[N, 2L], qqnum f32[N, K], ll f32[N, 2],
    zcounts f32[K, L, A] — allele-pop counts of the fresh z for the next
    step's P update).
    """
    r = _site_pass(seed, q, freq, geno, site_valid, hom, z_old, wg_pair,
                   None, u, sample=True, ll_kind="gen", n_col=2,
                   structure=structure, full_ll=False, interpret=interpret,
                   bits2=bits2, block=block)
    return r["z"], r["qqnum"], r["ll"], r["zcounts"]


@functools.partial(jax.jit, static_argnames=("structure",) + _STATIC)
def zq_gendiff_pass(seed, q, freq, geno, site_valid, hom, z_old, wg_pair, *,
                    structure, interpret=False, u=None, bits2=None,
                    block=None):
    """Production form of :func:`zq_gen_pass`: the G-update MH log-ratio as
    one column (the difference of the two, with ~4x fewer logs).

    Returns (z, qqnum, ll_diff f32[N], zcounts)."""
    r = _site_pass(seed, q, freq, geno, site_valid, hom, z_old, wg_pair,
                   None, u, sample=True, ll_kind="gendiff", n_col=2,
                   structure=structure, full_ll=False, interpret=interpret,
                   bits2=bits2, block=block)
    return r["z"], r["qqnum"], r["ll"][:, 0], r["zcounts"]


@functools.partial(jax.jit, static_argnames=_STATIC)
def zq_sample_pass(seed, q, freq, geno, site_valid, *, interpret=False,
                   u=None, bits2=None, block=None):
    """Sampling-only pass (mode 1, and the G-marginalized modes 2/3; the
    cal_lkh pass is deferred to stored steps).
    Returns (z, qqnum, zcounts)."""
    r = _site_pass(seed, q, freq, geno, site_valid, None, None, None, None,
                   u, sample=True, ll_kind=None, n_col=0,
                   structure=True, full_ll=False, interpret=interpret,
                   bits2=bits2, block=block)
    return r["z"], r["qqnum"], r["zcounts"]


@functools.partial(jax.jit, static_argnames=_STATIC)
def panel_loglik_mode1_pass(freq, q, geno, site_valid, z, *,
                            interpret=False, bits2=None, block=None):
    """cal_lkh for mode 1 (log_ld_noselfing_indv, mcmc.c:1869-1890) at the
    carried z — the deferred stored-step companion of
    :func:`zq_sample_pass`."""
    r = _site_pass(0, q, freq, geno, site_valid, None, z, None, None, None,
                   sample=False, ll_kind="mode1", n_col=0, structure=True,
                   full_ll=True, interpret=interpret, bits2=bits2,
                   block=block)
    return r["ll"][:, 0]


@functools.partial(jax.jit, static_argnames=_STATIC)
def zq_mode1_pass(seed, q, freq, geno, site_valid, *, interpret=False,
                  u=None, bits2=None, block=None):
    """Mode 1 in one pass: sample z + counts + the cal_lkh log-lik at the
    fresh z.  Returns (z, qqnum, ll f32[N], zcounts f32[K, L, A])."""
    r = _site_pass(seed, q, freq, geno, site_valid, None, None, None, None,
                   u, sample=True, ll_kind="mode1", n_col=0,
                   structure=True, full_ll=True, interpret=interpret,
                   bits2=bits2, block=block)
    return r["z"], r["qqnum"], r["ll"][:, 0], r["zcounts"]


@functools.partial(jax.jit, static_argnames=("structure",) + _STATIC)
def panel_loglik_pass(freq, q, geno, site_valid, hom, z, wg, *,
                      structure, interpret=False, bits2=None, block=None):
    """cal_lkh (mcmc.c:1916-1942) for modes 2/3 — per-individual log-lik at
    (q, gen, z).  wg f32[N, 1]."""
    r = _site_pass(0, q, freq, geno, site_valid, hom, z, wg, None, None,
                   sample=False, ll_kind="gen", n_col=1, structure=structure,
                   full_ll=True, interpret=interpret, bits2=bits2,
                   block=block)
    return r["ll"][:, 0]


@functools.partial(jax.jit, static_argnames=("pop",) + _STATIC)
def zq_f_pass(seed, q, freq, geno, site_valid, hom, z_old, f_pair, *,
              pop, interpret=False, u=None, bits2=None, block=None):
    """Sampling pass for the inbreeding modes (4/5): sample z + counts and
    the F-dependent log-likelihood terms of the MH update.

    pop=True (mode 4): ``f_pair`` f32[K, 2] = (current, proposed) per pop;
    the third return is fdiff f32[N, K] — per-individual per-pop sums of
    log L(f'_k) - log L(f_k) over same-z sites (sum over N gives the MH
    log-ratio of update_inbreedcoff_POP, mcmc.c:986-1050, corrected).

    pop=False (mode 5): ``f_pair`` f32[N, 2]; the third return is
    lldiff f32[N] — the per-individual MH log-ratio
    log L(f'_i) - log L(f_i) over same-z sites (update_F_IND,
    mcmc.c:888-910).

    Returns (z, qqnum, fdiff_or_lldiff, zcounts).
    """
    if pop:
        r = _site_pass(seed, q, freq, geno, site_valid, hom, z_old, None,
                       f_pair, u, sample=True, ll_kind="fpop", n_col=2,
                       structure=True, full_ll=False, interpret=interpret,
                       bits2=bits2, block=block)
        return r["z"], r["qqnum"], r["ll"], r["zcounts"]
    r = _site_pass(seed, q, freq, geno, site_valid, hom, z_old, f_pair,
                   None, u, sample=True, ll_kind="find", n_col=2,
                   structure=True, full_ll=False, interpret=interpret,
                   bits2=bits2, block=block)
    return r["z"], r["qqnum"], r["ll"][:, 0], r["zcounts"]


@functools.partial(jax.jit, static_argnames=("pop",) + _STATIC)
def panel_loglik_f_pass(freq, geno, site_valid, hom, z, f, *, pop,
                        interpret=False, bits2=None, block=None):
    """cal_lkh for modes 4/5 (log_ld_F_pop/indv, mcmc.c:1776-1847) at
    (P, F, Z).  f is f32[K, 1] (pop=True) or f32[N, 1]."""
    n = geno.shape[0]
    k = freq.shape[0]
    dummy_q = jnp.zeros((n, k), jnp.float32)
    if pop:
        r = _site_pass(0, dummy_q, freq, geno, site_valid, hom, z, None, f,
                       None, sample=False, ll_kind="fpop", n_col=1,
                       structure=True, full_ll=True, interpret=interpret,
                       bits2=bits2, block=block)
    else:
        r = _site_pass(0, dummy_q, freq, geno, site_valid, hom, z, f, None,
                       None, sample=False, ll_kind="find", n_col=1,
                       structure=True, full_ll=True, interpret=interpret,
                       bits2=bits2, block=block)
    return r["ll"][:, 0]
