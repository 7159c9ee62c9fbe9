"""Dirichlet-process mixture prior over individual selfing rates /
inbreeding coefficients (modes 3/5 with `-f 1`).

The reference implements the Chinese-restaurant-process collapsed Gibbs
sweep with a linked list of clusters (DPMM.c:124-321).  The vectorized
redesign is a fixed-capacity padded table:

  values  f32[N]  — the S/F value of each table slot
  counts  i32[N]  — occupancy; 0 = free slot
  assign  i32[N]  — table slot of each individual

The per-individual sweep (remove -> score tables + new-table mass ->
reassign) is inherently sequential (each step conditions on the updated
seating), so it is an exact `lax.scan` over individuals; every inner
operation is a masked O(N) vector op — no data-dependent shapes, no host
round-trips.

Mode 3 (selfing): the geometric likelihood is conjugate-ish — the
new-table mass is alpha * B(g,2) = alpha / (g (g+1)) and the new value is
Beta(g, 2) (gen_post_prob/sample_poster, DPMM.c:361-398).

Mode 5 (inbreeding F): the new-table mass needs int_0^1 exp(loglik_i(f)) df;
the reference uses Romberg quadrature (qromb, DPMM.c:40-117) and its
new-value sampler is an empty stub returning 0 (gen_nonconjg,
DPMM.c:401-407 — survey quirk).  We precompute the per-individual
log-likelihood curve on a fixed M-point grid once per sweep (one [N, L, M]
fused pass), use the trapezoid mass on the grid for the integral, and draw
new values by inverse-CDF on the same grid (griddy Gibbs) — a correct
sampler where the reference had a stub.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from instruct_jax.config import ModelSpec
from instruct_jax.data.dataset import Dataset
from instruct_jax.model import likelihood as lk

# f32 products feeding MH ratios / log-likelihoods: never TF32
_HI = jax.lax.Precision.HIGHEST

_EPS = 1e-30
_NEG = -1e30
GRID_M = 128

# The CRP sweeps' seat-choice Gumbel noise is state-independent, so it can
# be drawn either as one hoisted [N, N+1] plane (one batched threefry
# pass) or per row inside the scan (O(N) memory, but the per-iteration key
# derivation serializes).  The plane is O(N^2) memory — ~400 MB/chain at
# N=10k — so it is gated: hoisted up to this N, in-scan above.  The gate
# value awaits a measurement on the GPU.
_GUMBEL_PLANE_MAX_N = 2048


def _seat_gumbel(kg, n):
    """(plane_or_None); the scan body falls back to per-row draws from
    fold_in(kg, j) when the plane is gated off."""
    if n <= _GUMBEL_PLANE_MAX_N:
        return jax.random.gumbel(kg, (n, n + 1), jnp.float32)
    return None


def _row_gumbel(plane, kg, j, n):
    if plane is not None:
        return plane[j]
    return jax.random.gumbel(jax.random.fold_in(kg, j), (n + 1,),
                             jnp.float32)


class DpmTable(NamedTuple):
    values: jnp.ndarray   # f32[N]
    counts: jnp.ndarray   # i32[N]
    assign: jnp.ndarray   # i32[N]


def _slog(x):
    return jnp.log(jnp.maximum(x, _EPS))


def init_dpm(key, alpha: float, n: int) -> DpmTable:
    """Sequential CRP prior draw (init_DP, DPMM.c:124-161): individual j
    starts a new table w.p. alpha/(alpha+j) with value ~ U(0,1), else joins
    an existing table w.p. n_t/(alpha+j)."""
    values = jnp.zeros((n,), jnp.float32)
    counts = jnp.zeros((n,), jnp.int32)
    assign = jnp.zeros((n,), jnp.int32)
    kg, kv = jax.random.split(key)
    new_vals = jax.random.uniform(kv, (n,))
    gplane = _seat_gumbel(kg, n)

    def body(carry, j):
        values, counts, assign = carry
        log_masses = jnp.where(counts > 0,
                               _slog(counts.astype(jnp.float32)), _NEG)
        log_new = _slog(jnp.asarray(alpha, jnp.float32))
        all_masses = jnp.concatenate([log_new[None], log_masses])
        choice = jnp.argmax(all_masses + _row_gumbel(gplane, kg, j, n))
        is_new = choice == 0
        free = jnp.argmin(counts)                  # first empty slot
        slot = jnp.where(is_new, free, choice - 1)
        values = values.at[slot].set(
            jnp.where(is_new, new_vals[j], values[slot]))
        counts = counts.at[slot].add(1)
        assign = assign.at[j].set(slot)
        return (values, counts, assign), None

    (values, counts, assign), _ = jax.lax.scan(
        body, (values, counts, assign), jnp.arange(n))
    return DpmTable(values, counts, assign)


def _geom_log_density(value, gen):
    """log dgeom(value; gen) = (gen-1) log value + log(1-value)
    (dgeom, mcmc.c:1596-1604), with the gen==1 limit handled exactly."""
    g1 = (gen - 1).astype(jnp.float32)
    return jnp.where(g1 > 0, g1 * _slog(value), 0.0) + _slog(1.0 - value)


def crp_sweep_selfing(key, table: DpmTable, gen, alpha: float) -> DpmTable:
    """One collapsed-Gibbs CRP sweep for mode 3 (update_DP + gen_post_prob
    mode-3 branch, DPMM.c:165-199, 367-377).

    The new-table values Beta(g_j, 2) (sample_poster, DPMM.c:392-398)
    depend only on g_j, so the batched rejection sampler runs once up
    front instead of a `while_loop` per scan iteration.  The seat-choice
    Gumbel noise is
    hoisted as one [N, N+1] plane for N <= _GUMBEL_PLANE_MAX_N and drawn
    per row in-scan above it (state-independent either way — the gate
    trades the O(N^2) plane memory against the serial per-row key
    derivation)."""
    n = gen.shape[0]
    kg, kb = jax.random.split(key)
    gf_all = gen.astype(jnp.float32)
    new_vals = jax.random.beta(kb, gf_all, 2.0)    # [N]
    gplane = _seat_gumbel(kg, n)

    def body(carry, j):
        values, counts, assign = carry
        counts = counts.at[assign[j]].add(-1)      # delete(), DPMM.c:280-321
        g = gen[j]
        log_tables = jnp.where(
            counts > 0,
            _slog(counts.astype(jnp.float32)) + _geom_log_density(values, g),
            _NEG)
        gf = g.astype(jnp.float32)
        log_new = _slog(jnp.asarray(alpha, jnp.float32)) - _slog(gf) \
            - _slog(gf + 1.0)                       # alpha * B(g, 2)
        choice = jnp.argmax(
            jnp.concatenate([log_new[None], log_tables])
            + _row_gumbel(gplane, kg, j, n))
        is_new = choice == 0
        free = jnp.argmin(counts)
        slot = jnp.where(is_new, free, choice - 1)
        values = values.at[slot].set(jnp.where(is_new, new_vals[j],
                                               values[slot]))
        counts = counts.at[slot].add(1)
        assign = assign.at[j].set(slot)
        return (values, counts, assign), None

    carry, _ = jax.lax.scan(body, tuple(table), jnp.arange(n))
    return DpmTable(*carry)


def _f_grid_separable(data: Dataset, p0, p1, z, m: int):
    """The f-separable pieces of the grid curve: (hom_mask, c_const[N],
    n_het[N], grid[M]).  het same-z sites contribute log(2 p0 p1) +
    log(1-f); hom same-z sites split as log p0 + log(p0 + f(1-p0)); the
    z-mismatch / invalid sites are f-independent and handled by the
    caller."""
    z0, z1 = lk.split_copies(z, data.ploid)
    valid = (z0 == z1) & data.site_valid
    hom = data.hom
    grid = (jnp.arange(m, dtype=jnp.float32) + 0.5) / m
    het_mask = valid & ~hom
    n_het = het_mask.sum(axis=1).astype(jnp.float32)             # [N]
    c_het = jnp.where(het_mask, _slog(2.0 * p0 * p1),
                      0.0).sum(axis=1)                           # [N]
    hom_mask = valid & hom
    c_hom = jnp.where(hom_mask, _slog(p0), 0.0).sum(axis=1)      # [N]
    return hom_mask, z0, c_hom + c_het, n_het, grid


def f_loglik_grid(spec: ModelSpec, data: Dataset, freq, z,
                  m: int = GRID_M):
    """ll f32[N, M]: per-individual F-log-likelihood evaluated on the grid
    midpoints f_m = (m + 0.5)/M — the curve func() integrates
    (DPMM.c:327-358).

    The hom-site grid term is computed as K*A masked matmuls:
    at a hom same-z site p0 = freq[z0, l, x0], so

        sum_l hom_mask[n,l] log(p0 + f_m (1 - p0))
          = sum_{k,a}  M_ka[n,:] @ G_ka[:,m]

    with the 0/1 one-hot mask M_ka[n,l] = hom_mask & (z0==k) & (x0==a) and
    the per-locus grid table G_ka[l,m] = log(freq[k,l,a] + f_m(1-freq)).
    This replaces the dense [N, L, M] formulation (kept as
    :func:`f_loglik_grid_dense` for tests): O(N*L*K*A) matmul flops + a
    [K,L,A,M]-cell table instead of O(N*L*M) transcendentals — at the
    north-star panel (1000x10k, M=128) that is 1.3e12 log evaluations
    (seconds/step) turned into ~1.5e10 matmul flops (sub-ms)."""
    pz = lk.gather_freq_at_z(freq, data, z)             # [N, S]
    p0, p1 = lk.split_copies(pz, data.ploid)
    hom_mask, z0, c_const, n_het, grid = _f_grid_separable(
        data, p0, p1, z, m)
    x0, _ = lk.split_copies(data.geno, data.ploid)
    k_pops, _, a_max = freq.shape
    n = p0.shape[0]
    hom_term = jnp.zeros((n, m), jnp.float32)
    for k in range(k_pops):
        zm = hom_mask & (z0 == k)
        for a in range(a_max):
            mask = (zm & (x0 == a)).astype(jnp.float32)          # [N, L]
            fk = freq[k, :, a][:, None]                          # [L, 1]
            g_tab = _slog(fk + grid[None, :] * (1.0 - fk))       # [L, M]
            hom_term = hom_term + jax.lax.dot(
                mask, g_tab, precision=jax.lax.Precision.HIGHEST)
    return (hom_term + c_const[:, None]
            + n_het[:, None] * _slog(1.0 - grid)[None, :])


def f_loglik_grid_dense(spec: ModelSpec, data: Dataset, freq, z,
                        m: int = GRID_M):
    """Dense [N, L, M] reference formulation of :func:`f_loglik_grid`
    (direct transcription of the integrand func(), DPMM.c:327-358); used
    by tests to verify the matmul path and kept off the hot path."""
    pz = lk.gather_freq_at_z(freq, data, z)             # [N, S]
    p0, p1 = lk.split_copies(pz, data.ploid)
    hom_mask, _z0, c_const, n_het, grid = _f_grid_separable(
        data, p0, p1, z, m)
    inner = _slog(p0[..., None] + grid * (1.0 - p0[..., None]))  # [N, L, M]
    hom_term = (inner * hom_mask[..., None]).sum(axis=1)         # [N, M]
    return (hom_term + c_const[:, None]
            + n_het[:, None] * _slog(1.0 - grid)[None, :])


def crp_sweep_inbreeding(key, table: DpmTable, ll_grid,
                         alpha: float) -> DpmTable:
    """One CRP sweep for mode 5 (gen_post_prob mode-5 branch,
    DPMM.c:378-389) using the precomputed per-individual grid curve.

    Table values are grid midpoints, so scoring an existing table is a
    single gather; the new-table mass is the trapezoidal integral of
    exp(ll) over [0,1] (replacing qromb) and new values are drawn by
    inverse-CDF on the grid (replacing the gen_nonconjg stub)."""
    n, m = ll_grid.shape
    grid = (jnp.arange(m, dtype=jnp.float32) + 0.5) / m
    kg, kb = jax.random.split(key)
    gplane = _seat_gumbel(kg, n)
    # griddy new-value draws depend only on the (precomputed) grid curve,
    # so they batch outside the scan like the Beta draws of the mode-3
    # sweep; the per-j integrals are likewise a single [N]-row logsumexp.
    new_idx_all = jax.random.categorical(kb, ll_grid, axis=-1)  # [N]
    log_int_all = (jax.nn.logsumexp(ll_grid, axis=-1)
                   - jnp.log(float(m)))                         # [N]
    # table values carried as a one-hot [N, M] plane so scoring existing
    # tables against ll_j is a matvec instead of a 1000-index gather per
    # scan iteration (the matvec is one pass)
    vidx0 = jnp.clip((table.values * m).astype(jnp.int32), 0, m - 1)
    iota_m = jnp.arange(m, dtype=jnp.int32)
    onehot0 = (vidx0[:, None] == iota_m[None, :]).astype(jnp.float32)

    def body(carry, j):
        values, counts, assign, onehot = carry
        counts = counts.at[assign[j]].add(-1)
        ll_j = ll_grid[j]                                   # [M]
        # integral int exp(ll) df on the midpoint grid, in log space
        log_new = _slog(jnp.asarray(alpha, jnp.float32)) + log_int_all[j]
        # existing tables: values are grid midpoints, scored via one-hot
        log_tables = jnp.where(counts > 0,
                               _slog(counts.astype(jnp.float32))
                               + jnp.dot(onehot, ll_j, precision=_HI), _NEG)
        choice = jnp.argmax(
            jnp.concatenate([log_new[None], log_tables])
            + _row_gumbel(gplane, kg, j, n))
        is_new = choice == 0
        free = jnp.argmin(counts)
        slot = jnp.where(is_new, free, choice - 1)
        new_row = (new_idx_all[j] == iota_m).astype(jnp.float32)
        onehot = onehot.at[slot].set(
            jnp.where(is_new, new_row, onehot[slot]))
        values = values.at[slot].set(
            jnp.where(is_new, grid[new_idx_all[j]], values[slot]))
        counts = counts.at[slot].add(1)
        assign = assign.at[j].set(slot)
        return (values, counts, assign, onehot), None

    (values, counts, assign, _), _ = jax.lax.scan(
        body, tuple(table) + (onehot0,), jnp.arange(n))
    return DpmTable(values, counts, assign)


# ---------------------------------------------------------------------------
# Blocked sampler: truncated stick-breaking representation
# ---------------------------------------------------------------------------
#
# The CRP sweep above is exact but inherently sequential in N (survey §3.2
# "the one truly sequential-by-construction kernel").  For large panels the
# framework offers the standard parallel alternative: the truncated
# stick-breaking representation of the DP (Ishwaran & James 2001) with a
# static truncation level T.  One sweep is three fully vectorized draws —
#   sticks  v_t ~ Beta(1 + n_t, alpha + sum_{s>t} n_s)
#   values  theta_t | {j: c_j = t}  (conjugate Beta for the geometric
#           likelihood of mode 3; griddy inverse-CDF on the mode-5 grid)
#   seats   c_j ~ Cat_t( w_t * L_j(theta_t) )   — parallel over individuals
# — no scan over N, so the update maps onto the chip like every other
# kernel.  Exactness is up to the truncation (error decays as
# (n/(n+1))^{T-1}, negligible for T ≳ 30 at alpha ~ 10).


def _stick_log_weights(key, counts_t, alpha):
    """v_t ~ Beta(1 + n_t, alpha + tail_t); log w via cumulated sticks."""
    t = counts_t.shape[0]
    tail = jnp.cumsum(counts_t[::-1])[::-1] - counts_t
    v = jax.random.beta(key, 1.0 + counts_t, alpha + tail)
    v = v.at[t - 1].set(1.0)
    log1mv = _slog(1.0 - v)
    prefix = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(log1mv)[:-1]])
    return _slog(v) + prefix


def _seat_counts(assign, t_max):
    onehot = (assign[:, None] ==
              jnp.arange(t_max)[None, :]).astype(jnp.float32)
    return onehot.sum(axis=0), onehot


def stick_sweep_selfing(key, table: DpmTable, gen, alpha: float,
                        t_max: int) -> DpmTable:
    """One blocked sweep for mode 3 under truncation T=t_max."""
    k1, k2, k3 = jax.random.split(key, 3)
    assign = jnp.clip(table.assign, 0, t_max - 1)
    counts_t, onehot = _seat_counts(assign, t_max)
    logw = _stick_log_weights(k1, counts_t, alpha)

    # theta_t | members ~ Beta(1 + sum(g_j - 1), 1 + n_t)  (base U(0,1),
    # likelihood prod theta^{g_j-1}(1-theta) — dgeom, mcmc.c:1596-1604)
    g1 = (gen - 1).astype(jnp.float32)
    sum_g1 = jnp.dot(onehot.T, g1, precision=_HI)          # [T]
    theta = jax.random.beta(k2, 1.0 + sum_g1, 1.0 + counts_t)
    theta = jnp.clip(theta, 1e-6, 1.0 - 1e-6)

    # parallel reseat: logits [N, T]
    logits = (logw[None, :] + g1[:, None] * _slog(theta)[None, :]
              + _slog(1.0 - theta)[None, :])
    assign = jax.random.categorical(k3, logits, axis=-1).astype(jnp.int32)

    n = gen.shape[0]
    counts_new, _ = _seat_counts(assign, t_max)
    values = jnp.zeros((n,), jnp.float32).at[:t_max].set(theta)
    counts = jnp.zeros((n,), jnp.int32).at[:t_max].set(
        counts_new.astype(jnp.int32))
    return DpmTable(values, counts, assign)


def stick_sweep_inbreeding(key, table: DpmTable, ll_grid, alpha: float,
                           t_max: int) -> DpmTable:
    """One blocked sweep for mode 5: table values live on the grid, the
    per-table posterior over the grid is a segment-sum of members'
    log-likelihood curves (one [T, M] matmul), values are griddy draws."""
    n, m = ll_grid.shape
    grid = (jnp.arange(m, dtype=jnp.float32) + 0.5) / m
    k1, k2, k3 = jax.random.split(key, 3)
    assign = jnp.clip(table.assign, 0, t_max - 1)
    counts_t, onehot = _seat_counts(assign, t_max)
    logw = _stick_log_weights(k1, counts_t, alpha)

    table_ll = jnp.dot(onehot.T, ll_grid, precision=_HI)   # [T, M]
    theta_idx = jax.random.categorical(k2, table_ll, axis=-1)
    theta = grid[theta_idx]

    logits = logw[None, :] + ll_grid[:, theta_idx]          # [N, T]
    assign = jax.random.categorical(k3, logits, axis=-1).astype(jnp.int32)

    counts_new, _ = _seat_counts(assign, t_max)
    values = jnp.zeros((n,), jnp.float32).at[:t_max].set(theta)
    counts = jnp.zeros((n,), jnp.int32).at[:t_max].set(
        counts_new.astype(jnp.int32))
    return DpmTable(values, counts, assign)


def build_dpm_update(spec: ModelSpec, data: Dataset, axis_name=None):
    """Return `dpm_update(key, state) -> state` plugging the DP sweep into
    the mode-3/5 step (mcmc.c:337-342, 423-428): after the sweep, each
    individual's rate is its table's value.

    `spec.priors.dp_truncation == 0` selects the exact sequential CRP
    sweep; a positive value T selects the blocked truncated-stick-breaking
    sampler with T components (parallel over individuals — the large-N
    path)."""
    alpha = spec.priors.alpha_dpm
    t_max = spec.priors.dp_truncation
    n = data.n_indv
    if not 0 <= t_max <= n:
        raise ValueError(
            f"dp_truncation={t_max} out of range: must be 0 (exact CRP "
            f"sweep) or in [2, {n}] (= n_indv; the padded table has one "
            "slot per individual)")
    if t_max == 1:
        raise ValueError("dp_truncation=1 collapses the DP to a single "
                         "cluster; use 0 for the exact CRP sweep or T >= 2")

    def dpm_update(key, state):
        table = DpmTable(state.dpm_values, state.dpm_counts,
                         state.dpm_assign)
        if spec.mode == 3:
            if t_max > 0:
                table = stick_sweep_selfing(key, table, state.gen, alpha,
                                            t_max)
            else:
                table = crp_sweep_selfing(key, table, state.gen, alpha)
        else:
            # the grid curve sums over loci -> psummed under loci sharding;
            # the CRP/stick draws are then replicated (same keys)
            ll_grid = f_loglik_grid(spec, data, state.freq, state.z)
            if axis_name is not None:
                ll_grid = jax.lax.psum(ll_grid, axis_name)
            if t_max > 0:
                table = stick_sweep_inbreeding(key, table, ll_grid, alpha,
                                               t_max)
            else:
                table = crp_sweep_inbreeding(key, table, ll_grid, alpha)
        rates = table.values[table.assign]
        return state._replace(rates=rates, dpm_values=table.values,
                              dpm_counts=table.counts,
                              dpm_assign=table.assign)

    return dpm_update
