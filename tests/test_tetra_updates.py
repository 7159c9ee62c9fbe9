"""Tetraploid P and Z updates (tetra/engine.py): the allele-pop counts over
the copy-major [N, 4L] slot views, and the per-copy inverse-CDF z draw,
each against a numpy evaluation."""

import jax
import numpy as np

from instruct_jax.config import ModelSpec
from instruct_jax.data.synthetic import synthetic_tetra_panel
from instruct_jax.tetra import engine as te


def _panel(autopoly=True, n=30, l=17, k=3):
    panel = synthetic_tetra_panel(n_indv=n, n_loci=l, n_pops=k, n_alleles=2,
                                  seed=3, autopoly=autopoly)
    spec = ModelSpec(mode=2, n_pops=k, ploid=4, autopoly=autopoly)
    st = te.init_tetra_state(jax.random.key(0), spec, panel.data)
    return panel.data, spec, st


def _np_counts(spec, data, z, geno, slots):
    k, a, l = spec.n_pops, data.max_alleles, data.n_loci
    zn, gn = np.asarray(z), np.asarray(geno)
    out = np.zeros((k, l, a), np.float32)
    v = np.asarray(data.site_valid)
    for kk in range(k):
        for ai in range(a):
            for c in slots:
                m = (v & (zn[:, c * l:(c + 1) * l] == kk)
                     & (gn[:, c * l:(c + 1) * l] == ai))
                out[kk, :, ai] += m.sum(axis=0)
    return out


def test_auto_view_counts_match():
    data, spec, st = _panel(autopoly=True)
    got = te.tetra_allele_counts(spec, data, st.z, st.geno, range(4))
    np.testing.assert_array_equal(
        np.asarray(got), _np_counts(spec, data, st.z, st.geno, range(4)))


def test_allo_system_counts_match():
    data, spec, st = _panel(autopoly=False)
    for slots in ([0, 1], [2, 3]):
        got = te.tetra_allele_counts(spec, data, st.z, st.geno, slots)
        np.testing.assert_array_equal(
            np.asarray(got), _np_counts(spec, data, st.z, st.geno, slots))


def test_z_draw_matches_xla_given_same_uniforms():
    """_update_zq_tetra's draw z = sum_j 1[u*tot > cum_j] equals a numpy
    inverse CDF fed the uniform plane the update draws from its key, and
    its Q counts equal the recount of that z."""
    data, spec, st = _panel(autopoly=True, n=12, l=9, k=3)
    tables = te.build_tables(spec, data)
    l, k = data.n_loci, spec.n_pops
    n = st.q.shape[0]
    key = jax.random.key(21)
    z, _q = te._update_zq_tetra(key, tables, spec, data, st.freq, st.freq2,
                                st.q, st.alpha, st.geno)
    kz, _ = jax.random.split(key)
    u = np.asarray(jax.random.uniform(kz, (n, 4 * l)))
    f = np.asarray(st.freq)
    gn = np.asarray(st.geno).astype(np.int64)
    li = np.tile(np.arange(l), 4)[None, :]
    w = np.stack([np.asarray(st.q)[:, kk][:, None] * f[kk][li, gn]
                  for kk in range(k)])                     # [K, N, 4L]
    cum = np.cumsum(w, axis=0)
    z_ref = (u[None] * cum[-1][None] > cum[:-1]).sum(0)
    np.testing.assert_array_equal(np.asarray(z).astype(np.int64), z_ref)
