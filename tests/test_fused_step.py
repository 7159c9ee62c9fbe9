"""Fused Pallas step kernels (Triton route, interpret mode on CPU) vs the
XLA path.

Fed the same uniforms, the kernels must reproduce the XLA formulas exactly:
same z draws, same counts, same log-likelihoods (within f32 tolerance).
Without injected uniforms the in-kernel counter hash must give draws that
do not depend on the block shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.kernels import fused_step as fs
from instruct_jax.mcmc import updates as up
from instruct_jax.mcmc.state import masked_z_counts
from instruct_jax.model import likelihood as lk


@pytest.fixture(scope="module", params=[(17, 23, 3, 3), (9, 300, 2, 2)])
def setup(request):
    n, l, k, a = request.param
    panel = synthetic_panel(n_indv=n, n_loci=l, n_pops=k, n_alleles=a,
                            missing_rate=0.15, seed=5)
    data = panel.data
    rng = np.random.default_rng(0)
    freq = rng.dirichlet(np.ones(a), size=(k, l)).astype(np.float32)
    freq = jnp.asarray(np.where(np.asarray(data.allele_valid)[None],
                                freq, 0.0))
    q = jnp.asarray(rng.dirichlet(np.ones(k), size=n), jnp.float32)
    z = jnp.asarray(rng.integers(0, k, size=data.geno.shape), jnp.int8)
    gen = jnp.asarray(rng.integers(1, 12, size=n), jnp.int32)
    gen_prop = jnp.asarray(rng.integers(1, 12, size=n), jnp.int32)
    return data, freq, q, z, gen, gen_prop, k, a


def test_allele_counts_matches_xla(setup):
    """The [K, L, A] allele-pop counts the sampling pass carries out of its
    fresh z equal the XLA count loops (update_P, mcmc.c:815-845)."""
    data, freq, q, z, gen, gen_prop, k, a = setup
    z_new, qqnum, zcounts = fs.zq_sample_pass(
        jnp.asarray([3, 4], jnp.int32), q, freq, data.geno,
        data.site_valid, interpret=True)
    spec = ModelSpec(mode=2, n_pops=k)
    want = np.asarray(up.allele_pop_counts(spec, data, z_new, None))
    np.testing.assert_array_equal(np.asarray(zcounts), want)
    np.testing.assert_array_equal(np.asarray(qqnum),
                                  np.asarray(masked_z_counts(z_new, data, k)))


def _xla_z_draw(u, q, freq, data, k):
    """The exact inverse-CDF draw of update_zq (updates.py) given u."""
    terms = [q[:, kk][:, None] * pk
             for kk, pk in enumerate(lk.per_pop_copy_probs(freq, data))]
    total = sum(terms[1:], terms[0])
    uu = u * total
    z = jnp.zeros(u.shape, jnp.int8)
    cum = jnp.zeros_like(total)
    for kk in range(k - 1):
        cum = cum + terms[kk]
        z = z + (uu > cum).astype(jnp.int8)
    return z


@pytest.mark.parametrize("type_freq", [0, 1])
def test_zq_gen_pass_matches_xla(setup, type_freq):
    data, freq, q, z_old, gen, gen_prop, k, a = setup
    u = jax.random.uniform(jax.random.key(3), data.geno.shape,
                           minval=1e-6, maxval=1 - 1e-6)
    wg_pair = jnp.exp2(1.0 - jnp.stack([gen, gen_prop], 1)
                       .astype(jnp.float32))
    z, qqnum, ll2, zcounts = fs.zq_gen_pass(
        0, q, freq, data.geno, data.site_valid, data.hom, z_old, wg_pair,
        structure=(type_freq == 1), interpret=True, u=u)
    want_z = _xla_z_draw(u, q, freq, data, k)
    np.testing.assert_array_equal(np.asarray(z), np.asarray(want_z))
    spec_c = ModelSpec(mode=2, n_pops=k)
    np.testing.assert_allclose(
        np.asarray(zcounts),
        np.asarray(up.allele_pop_counts(spec_c, data, z, None)), atol=1e-4)
    np.testing.assert_allclose(np.asarray(qqnum),
                               np.asarray(masked_z_counts(z, data, k)),
                               atol=1e-4)
    # fresh-z semantics: the sampling pass evaluates the G columns at
    # the z it has just drawn (the sweep is "Z then G|z")
    spec = ModelSpec(mode=2, n_pops=k, type_freq=type_freq)
    rates = jnp.zeros((k,), jnp.float32)
    zf = jnp.asarray(z, jnp.int8)
    ll_cur = lk.per_indv_loglik(spec, data, freq, zf, q, gen, rates)
    ll_prop = lk.per_indv_loglik(spec, data, freq, zf, q, gen_prop,
                                 rates)
    np.testing.assert_allclose(np.asarray(ll2[:, 0]), np.asarray(ll_cur),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(ll2[:, 1]), np.asarray(ll_prop),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("type_freq", [0, 1])
def test_panel_loglik_pass_matches_xla(setup, type_freq):
    data, freq, q, z, gen, gen_prop, k, a = setup
    wg = jnp.exp2(1.0 - gen.astype(jnp.float32))[:, None]
    got = fs.panel_loglik_pass(freq, q, data.geno, data.site_valid,
                               data.hom, z, wg,
                               structure=(type_freq == 1), interpret=True)
    spec = ModelSpec(mode=2, n_pops=k, type_freq=type_freq)
    rates = jnp.zeros((k,), jnp.float32)
    want = lk.per_indv_loglik(spec, data, freq, z, q, gen, rates)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-3)


def test_zq_mode1_pass_matches_xla(setup):
    data, freq, q, z_old, gen, gen_prop, k, a = setup
    u = jax.random.uniform(jax.random.key(7), data.geno.shape,
                           minval=1e-6, maxval=1 - 1e-6)
    z, qqnum, ll, _zc = fs.zq_mode1_pass(0, q, freq, data.geno,
                                         data.site_valid, interpret=True,
                                         u=u)
    want_z = _xla_z_draw(u, q, freq, data, k)
    np.testing.assert_array_equal(np.asarray(z), np.asarray(want_z))
    spec = ModelSpec(mode=1, n_pops=k)
    want = lk.per_indv_loglik(spec, data, freq, z, q, None, None)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(want),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("pop", [True, False])
def test_zq_f_pass_matches_xla(setup, pop):
    data, freq, q, z_old, gen, gen_prop, k, a = setup
    n = data.geno.shape[0]
    rng = np.random.default_rng(8)
    if pop:
        f_pair = jnp.asarray(rng.uniform(0.1, 0.9, (k, 2)), jnp.float32)
    else:
        f_pair = jnp.asarray(rng.uniform(0.1, 0.9, (n, 2)), jnp.float32)
    u = jax.random.uniform(jax.random.key(5), data.geno.shape,
                           minval=1e-6, maxval=1 - 1e-6)
    z, qqnum, ll, zcounts = fs.zq_f_pass(0, q, freq, data.geno,
                                         data.site_valid, data.hom, z_old,
                                         f_pair, pop=pop, interpret=True,
                                         u=u)
    want_z = _xla_z_draw(u, q, freq, data, k)
    np.testing.assert_array_equal(np.asarray(z), np.asarray(want_z))

    # reference formulas via the XLA likelihood on same-z sites, at the
    # FRESH z (the sampling pass conditions its F terms on the z it drew)
    pz = lk.gather_freq_at_z(freq, data, z)
    p0, p1 = lk.split_copies(pz, 2)
    z0, z1 = lk.split_copies(z, 2)
    mask = np.asarray((z0 == z1) & data.site_valid)
    hom = np.asarray(data.hom)
    p0, p1 = np.asarray(p0), np.asarray(p1)

    def lp(fsite):
        gf = np.where(hom, p0 * p0 * (1 - fsite) + p0 * fsite,
                      2 * p0 * p1 * (1 - fsite))
        return np.log(np.maximum(gf, 1e-30))

    fp = np.asarray(f_pair)
    z0n = np.asarray(z0)
    if pop:
        d = (lp(fp[z0n, 1]) - lp(fp[z0n, 0])) * mask
        want = np.stack([np.where(z0n == kk, d, 0.0).sum(1)
                         for kk in range(k)], axis=1)
        np.testing.assert_allclose(np.asarray(ll), want, rtol=2e-4,
                                   atol=2e-3)
    else:
        # single diff column: log L(f') - log L(f) over same-z sites
        want = ((lp(fp[:, 1][:, None]) - lp(fp[:, 0][:, None]))
                * mask).sum(1)
        np.testing.assert_allclose(np.asarray(ll), want, rtol=2e-4,
                                   atol=2e-3)


@pytest.mark.parametrize("pop", [True, False])
def test_panel_loglik_f_pass_matches_xla(setup, pop):
    data, freq, q, z, gen, gen_prop, k, a = setup
    n = data.geno.shape[0]
    rng = np.random.default_rng(9)
    rates = jnp.asarray(rng.uniform(0.1, 0.9, (k if pop else n,)),
                        jnp.float32)
    got = fs.panel_loglik_f_pass(freq, data.geno, data.site_valid,
                                 data.hom, z, rates[:, None], pop=pop,
                                 interpret=True)
    spec = ModelSpec(mode=4 if pop else 5, n_pops=k)
    want = lk.per_indv_loglik(spec, data, freq, z, q, None, rates)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-3)


def test_draws_independent_of_block_shape(setup):
    """The counter-hash draws depend on (seed, individual, copy, locus)
    only: two tilings — one of them far off the panel's multiples — give
    the same z, the same counts and the same log-ratio columns, and the
    draws equal the host-side twin fed back as injected uniforms."""
    data, freq, q, z_old, gen, gen_prop, k, a = setup
    wg = jnp.exp2(1.0 - jnp.stack([gen, gen_prop], 1).astype(jnp.float32))
    seed = jnp.asarray([123, -77], jnp.int32)
    kw = dict(sample=True, ll_kind="gen", n_col=2, structure=True,
              full_ll=False, interpret=True)
    r1 = fs._site_pass(seed, q, freq, data.geno, data.site_valid, data.hom,
                       z_old, wg, None, None, block=(16, 8, 16), **kw)
    r2 = fs._site_pass(seed, q, freq, data.geno, data.site_valid, data.hom,
                       z_old, wg, None, None, block=(8, 4, 128), **kw)
    np.testing.assert_array_equal(np.asarray(r1["z"]), np.asarray(r2["z"]))
    np.testing.assert_array_equal(np.asarray(r1["qqnum"]),
                                  np.asarray(r2["qqnum"]))
    np.testing.assert_array_equal(np.asarray(r1["zcounts"]),
                                  np.asarray(r2["zcounts"]))
    np.testing.assert_allclose(np.asarray(r1["ll"]), np.asarray(r2["ll"]),
                               rtol=1e-5, atol=1e-5)
    u = fs.site_uniforms(seed, *data.site_valid.shape)
    r3 = fs._site_pass(seed, q, freq, data.geno, data.site_valid, data.hom,
                       z_old, wg, None, u, **kw)
    np.testing.assert_array_equal(np.asarray(r3["z"]), np.asarray(r1["z"]))


@pytest.mark.parametrize("type_freq", [0, 1])
def test_zq_gendiff_pass_matches_gen_difference(setup, type_freq):
    """The production single-column G log-ratio equals the difference of
    the two zq_gen_pass columns (same z draw, same counts)."""
    data, freq, q, z_old, gen, gen_prop, k, a = setup
    u = jax.random.uniform(jax.random.key(13), data.geno.shape,
                           minval=1e-6, maxval=1 - 1e-6)
    wg_pair = jnp.exp2(1.0 - jnp.stack([gen, gen_prop], 1)
                       .astype(jnp.float32))
    structure = type_freq == 1
    z1, qq1, ll2, zc1 = fs.zq_gen_pass(
        0, q, freq, data.geno, data.site_valid, data.hom, z_old, wg_pair,
        structure=structure, interpret=True, u=u)
    z2, qq2, diff, zc2 = fs.zq_gendiff_pass(
        0, q, freq, data.geno, data.site_valid, data.hom, z_old, wg_pair,
        structure=structure, interpret=True, u=u)
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))
    np.testing.assert_allclose(np.asarray(qq1), np.asarray(qq2), atol=1e-4)
    np.testing.assert_allclose(np.asarray(diff),
                               np.asarray(ll2[:, 1] - ll2[:, 0]),
                               rtol=2e-4, atol=2e-3)


def test_zq_sample_pass_and_deferred_mode1_loglik(setup):
    """Sampling-only pass + deferred cal_lkh reproduce zq_mode1_pass."""
    data, freq, q, z_old, gen, gen_prop, k, a = setup
    u = jax.random.uniform(jax.random.key(21), data.geno.shape,
                           minval=1e-6, maxval=1 - 1e-6)
    z1, qq1, ll1, _ = fs.zq_mode1_pass(0, q, freq, data.geno,
                                       data.site_valid, interpret=True,
                                       u=u)
    z2, qq2, _zc = fs.zq_sample_pass(0, q, freq, data.geno,
                                     data.site_valid, interpret=True, u=u)
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))
    np.testing.assert_allclose(np.asarray(qq1), np.asarray(qq2), atol=1e-4)
    ll2 = fs.panel_loglik_mode1_pass(freq, q, data.geno, data.site_valid,
                                     jnp.asarray(z2, jnp.int8),
                                     interpret=True)
    np.testing.assert_allclose(np.asarray(ll2), np.asarray(ll1),
                               rtol=2e-4, atol=2e-3)


def test_packed_bits2_plane_matches_unpacked():
    """The single packed int8 site plane (dataset.bits2) reproduces the
    unpacked (geno x2, valid, hom) operand route bit-for-bit on a
    diploid-biallelic panel, across the sampling, diff, and stored-step
    pass families."""
    panel = synthetic_panel(n_indv=21, n_loci=130, n_pops=3, n_alleles=2,
                            missing_rate=0.2, seed=12)
    data = panel.data
    assert data.bits2 is not None
    rng = np.random.default_rng(3)
    k = 3
    freq = rng.dirichlet(np.ones(2), size=(k, data.n_loci)).astype(
        np.float32)
    freq = jnp.asarray(freq)
    q = jnp.asarray(rng.dirichlet(np.ones(k), size=data.n_indv),
                    jnp.float32)
    z_old = jnp.asarray(rng.integers(0, k, size=data.geno.shape), jnp.int8)
    gen = jnp.asarray(rng.integers(1, 9, size=data.n_indv), jnp.int32)
    gen_p = jnp.asarray(rng.integers(1, 9, size=data.n_indv), jnp.int32)
    wg_pair = jnp.exp2(1.0 - jnp.stack([gen, gen_p], 1).astype(jnp.float32))
    u = jax.random.uniform(jax.random.key(2), data.geno.shape,
                           minval=1e-6, maxval=1 - 1e-6)

    for structure in (True, False):
        a_ = fs.zq_gendiff_pass(0, q, freq, data.geno, data.site_valid,
                                data.hom, z_old, wg_pair,
                                structure=structure, interpret=True, u=u)
        b_ = fs.zq_gendiff_pass(0, q, freq, data.geno, data.site_valid,
                                data.hom, z_old, wg_pair,
                                structure=structure, interpret=True, u=u,
                                bits2=data.bits2)
        np.testing.assert_array_equal(np.asarray(a_[0]), np.asarray(b_[0]))
        np.testing.assert_allclose(np.asarray(a_[1]), np.asarray(b_[1]),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(a_[2]), np.asarray(b_[2]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(a_[3]), np.asarray(b_[3]),
                                   atol=1e-4)

    for pop in (True, False):
        f_pair = jnp.asarray(
            rng.uniform(0.1, 0.9, (k if pop else data.n_indv, 2)),
            jnp.float32)
        a_ = fs.zq_f_pass(0, q, freq, data.geno, data.site_valid, data.hom,
                          z_old, f_pair, pop=pop, interpret=True, u=u)
        b_ = fs.zq_f_pass(0, q, freq, data.geno, data.site_valid, data.hom,
                          z_old, f_pair, pop=pop, interpret=True, u=u,
                          bits2=data.bits2)
        np.testing.assert_array_equal(np.asarray(a_[0]), np.asarray(b_[0]))
        np.testing.assert_allclose(np.asarray(a_[2]), np.asarray(b_[2]),
                                   rtol=1e-5, atol=1e-5)

    z = jnp.asarray(rng.integers(0, k, size=data.geno.shape), jnp.int8)
    wg = jnp.exp2(1.0 - gen.astype(jnp.float32))[:, None]
    a_ = fs.panel_loglik_pass(freq, q, data.geno, data.site_valid, data.hom,
                              z, wg, structure=True, interpret=True)
    b_ = fs.panel_loglik_pass(freq, q, data.geno, data.site_valid, data.hom,
                              z, wg, structure=True, interpret=True,
                              bits2=data.bits2)
    np.testing.assert_allclose(np.asarray(a_), np.asarray(b_), rtol=1e-6)

    a_ = fs.zq_mode1_pass(0, q, freq, data.geno, data.site_valid,
                          interpret=True, u=u)
    b_ = fs.zq_mode1_pass(0, q, freq, data.geno, data.site_valid,
                          interpret=True, u=u, bits2=data.bits2)
    np.testing.assert_array_equal(np.asarray(a_[0]), np.asarray(b_[0]))
    np.testing.assert_allclose(np.asarray(a_[2]), np.asarray(b_[2]),
                               rtol=1e-5, atol=1e-5)
