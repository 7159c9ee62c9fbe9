"""Tetraploid genotype move and site log-likelihood (tetra/engine.py) vs
independent references.

* the ordered-genotype Gibbs move (update_geno, poly_geno.c:520-580):
  ``engine._sample_geno`` must pick, at every site, the argmax of the
  candidate weights plus the Gumbel noise it draws — rebuilt here from the
  engine's key schedule and fed to a reference weight evaluation;
* the S-update site values and the conditional site log-likelihood
  (cal_lkd, poly_geno.c:715-735) against plain numpy indexing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec
from instruct_jax.data.synthetic import synthetic_tetra_panel
from instruct_jax.tetra import engine as eng


def _xla_choice(tables, spec, data, freq, freq2, q, table_log, z, gumbel):
    """Reference argmax_c [w_c + gumbel_c] with the engine's own weight
    helpers (the streaming-Gumbel path of _sample_geno, gumbel injected)."""
    n, l = data.n_distinct.shape
    zc = eng._split4(z)
    same_z = (zc[0] == zc[1]) & (zc[1] == zc[2]) & (zc[2] == zc[3])
    mix1 = eng._mix_per_allele(freq, q)
    mix2 = (eng._mix_per_allele(freq2, q) if not spec.autopoly else mix1)
    a = freq.shape[2]
    dist = eng._split4(data.distinct)
    n_cand = int(tables.n_patterns_np.max())
    nc = tables.cand_nc.astype(jnp.int32)

    best = jnp.full((n, l), -1e30)
    choice = jnp.zeros((n, l), jnp.int32)
    for c in range(n_cand):
        cls_idx = tables.cand_cls[c].astype(jnp.int32)
        w_same = eng._table_at(table_log, zc[0], cls_idx)
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
            w_mix = w_mix + jnp.log(jnp.maximum(val, 1e-30))
        w = jnp.where(same_z, w_same, w_mix)
        v = jnp.where(c < nc, w + gumbel[c], -1e30)
        take = v > best
        best = jnp.where(take, v, best)
        choice = jnp.where(take, c, choice)
    return choice


def _state(autopoly, n_alleles, n, l, seed, missing_rate=0.0):
    panel = synthetic_tetra_panel(n_indv=n, n_loci=l, n_pops=3,
                                  n_alleles=n_alleles, autopoly=autopoly,
                                  missing_rate=missing_rate, seed=seed)
    data = panel.data
    spec = ModelSpec(mode=2, ploid=4, n_pops=3, autopoly=autopoly)
    tables = eng.build_tables(spec, data)
    key = jax.random.key(seed)
    kf, kf2, kq, kz, ks = jax.random.split(key, 5)
    a, k = data.max_alleles, 3
    freq = jax.random.dirichlet(kf, jnp.ones(a), (k, l)).astype(jnp.float32)
    freq2 = jax.random.dirichlet(kf2, jnp.ones(a), (k, l)).astype(
        jnp.float32)
    q = jax.random.dirichlet(kq, jnp.ones(k), (n,)).astype(jnp.float32)
    z = jax.random.randint(kz, (n, 4 * l), 0, k, dtype=jnp.int8)
    # force some same-z sites so both weight branches are exercised
    z = z.at[: n // 2].set(jnp.tile(z[: n // 2, :l], (1, 4)).astype(jnp.int8))
    log_hwe = eng.log_hwe_table(tables, spec, freq, freq2)
    return data, spec, tables, freq, freq2, q, z, log_hwe, ks


@pytest.mark.parametrize("autopoly,n_alleles", [(True, 2), (False, 2),
                                                (True, 4), (False, 4)])
def test_geno_move_matches_reference(autopoly, n_alleles):
    data, spec, tables, freq, freq2, q, z, log_hwe, ks = _state(
        autopoly, n_alleles, 12, 17, 3)
    n, l = data.n_distinct.shape
    rates = jax.random.uniform(ks, (3,), minval=0.1, maxval=0.9)
    table_log = eng.selfing_equilibrium(tables, log_hwe, rates)
    key = jax.random.key(11)
    n_cand = int(tables.n_patterns_np.max())
    # the Gumbel planes _sample_geno draws from ``key``
    gumbel = jnp.stack([-jnp.log(-jnp.log(jax.random.uniform(
        jax.random.fold_in(key, c), (n, l), minval=1e-12, maxval=1.0)))
        for c in range(n_cand)])
    got = eng._sample_geno(key, tables, spec, data, freq, freq2, q,
                           table_log, z)
    want = eng._reconstruct_geno(
        tables, data,
        _xla_choice(tables, spec, data, freq, freq2, q, table_log, z,
                    gumbel), n_cand)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_reconstruct_matches_candidate_slots():
    """_reconstruct_geno routes choice -> slots exactly like the direct
    per-candidate slot evaluation."""
    panel = synthetic_tetra_panel(n_indv=8, n_loci=9, n_pops=2,
                                  n_alleles=4, autopoly=False, seed=1)
    data = panel.data
    spec = ModelSpec(mode=2, ploid=4, n_pops=2, autopoly=False)
    tables = eng.build_tables(spec, data)
    n, l = data.n_distinct.shape
    n_cand = int(tables.n_patterns_np.max())
    choice = jax.random.randint(jax.random.key(0), (n, l), 0, n_cand)
    choice = jnp.minimum(choice, tables.cand_nc.astype(jnp.int32) - 1)
    got = eng._reconstruct_geno(tables, data, choice, n_cand)
    want_slots = []
    for m in range(4):
        vm = jnp.zeros((n, l), jnp.int32)
        for c in range(n_cand):
            slots = eng._candidate_slots(tables, data, c)
            vm = jnp.where(choice == c, slots[m], vm)
        want_slots.append(vm)
    want = jnp.concatenate(want_slots, axis=1).astype(jnp.int8)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _np_class(tables, geno):
    """class index [N, L] of the ordered genotype by numpy indexing."""
    g = np.asarray(geno).astype(np.int64)
    l = g.shape[1] // 4
    s = [g[:, m * l:(m + 1) * l] for m in range(4)]
    nm = tables.n_max
    packed = ((s[0] * nm + s[1]) * nm + s[2]) * nm + s[3]
    lookup_l = np.asarray(tables.lookup)[np.asarray(tables.cls)]   # [L, P]
    return lookup_l[np.arange(l)[None, :], packed]


def _valid_geno(tables, data, n, l, key):
    n_cand = int(tables.n_patterns_np.max())
    choice = jnp.minimum(jax.random.randint(key, (n, l), 0, n_cand),
                         tables.cand_nc.astype(jnp.int32) - 1)
    return eng._reconstruct_geno(tables, data, choice, n_cand)


@pytest.mark.parametrize("autopoly,n_alleles", [(True, 4), (False, 2),
                                                (False, 4)])
def test_s_log_ratio_matches_reference(autopoly, n_alleles):
    """The S-update per-pop log-ratio the step forms (_site_class +
    _table_at on the current / proposed tables, masked per-pop sums)
    equals the same sums by numpy indexing."""
    data, spec, tables, freq, freq2, q, z, log_hwe, ks = _state(
        autopoly, n_alleles, 10, 19, 7)
    n, l, k = 10, data.n_loci, 3
    geno = _valid_geno(tables, data, n, l, jax.random.key(5))
    k1, k2 = jax.random.split(ks)
    tab_cur = eng.selfing_equilibrium(
        tables, log_hwe, jax.random.uniform(k1, (k,), minval=0.1,
                                            maxval=0.9))
    tab_prop = eng.selfing_equilibrium(
        tables, log_hwe, jax.random.uniform(k2, (k,), minval=0.1,
                                            maxval=0.9))
    cls_idx = eng._site_class(tables, data, geno)
    zc = eng._split4(z)
    same = (zc[0] == zc[1]) & (zc[1] == zc[2]) & (zc[2] == zc[3])
    diff = jnp.where(same & data.site_valid,
                     eng._table_at(tab_prop, zc[0], cls_idx)
                     - eng._table_at(tab_cur, zc[0], cls_idx), 0.0)
    got = jnp.stack([jnp.where(zc[0] == kk, diff, 0.0).sum()
                     for kk in range(k)])

    cls_np = _np_class(tables, geno)
    np.testing.assert_array_equal(np.asarray(cls_idx), cls_np)
    z0 = np.asarray(zc[0])
    li = np.arange(l)[None, :]
    tc, tp = np.asarray(tab_cur), np.asarray(tab_prop)
    d = np.where(np.asarray(same & data.site_valid),
                 tp[z0, li, cls_np] - tc[z0, li, cls_np], 0.0)
    want = np.stack([np.where(z0 == kk, d, 0.0).sum() for kk in range(k)])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("autopoly,n_alleles", [(True, 4), (False, 2),
                                                (False, 4)])
def test_site_loglik_matches_reference(autopoly, n_alleles):
    """site_indv_loglik (cal_lkd summed over loci) equals a numpy
    evaluation of both weight branches: same-z sites read the genotype
    table, mixed-z sites multiply per-slot frequencies."""
    data, spec, tables, freq, freq2, q, z, log_hwe, ks = _state(
        autopoly, n_alleles, 11, 18, 9, missing_rate=0.1)
    n, l = 11, data.n_loci
    geno = _valid_geno(tables, data, n, l, jax.random.key(2))
    table = eng.selfing_equilibrium(
        tables, log_hwe, jax.random.uniform(ks, (3,), minval=0.1,
                                            maxval=0.9))
    got = eng.site_indv_loglik(tables, spec, data, freq, freq2, z, geno,
                               table)

    cls_np = _np_class(tables, geno)
    zn = np.asarray(z).astype(np.int64)
    gn = np.asarray(geno).astype(np.int64)
    zs = [zn[:, m * l:(m + 1) * l] for m in range(4)]
    gs = [gn[:, m * l:(m + 1) * l] for m in range(4)]
    li = np.arange(l)[None, :]
    same = (zs[0] == zs[1]) & (zs[1] == zs[2]) & (zs[2] == zs[3])
    ll_same = np.asarray(table)[zs[0], li, cls_np]
    lmult = np.asarray(tables.log_mult)[np.asarray(tables.cls)]    # [L, G]
    ll_mix = lmult[li, cls_np]
    for m in range(4):
        f = np.asarray(freq if (autopoly or m < 2) else freq2)
        ll_mix = ll_mix + np.log(np.maximum(f[zs[m], li, gs[m]], 1e-30))
    site = np.where(same, ll_same, ll_mix)
    want = np.where(np.asarray(data.site_valid), site, 0.0).sum(axis=1)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)
