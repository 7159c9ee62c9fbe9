"""Unit tests of the genotype-likelihood math against brute-force NumPy
reimplementations of the reference formulas (mcmc.c:1683-1942)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.model import likelihood as lk


def ref_genofreq(p0, p1, hom, g):
    """Literal transcription of genofreq() (mcmc.c:1683-1703)."""
    if hom:
        result = p0 ** 2
        temp = 2 * p0 * (1 - p0)
        for _ in range(1, g):
            temp /= 2
            result += temp / 2
        return result
    return 2 * p0 * p1 * 0.5 ** (g - 1)


def ref_genofreq_f(p0, p1, hom, f):
    if hom:
        return p0 * p0 * (1 - f) + p0 * f
    return 2 * p0 * p1 * (1 - f)


@pytest.mark.parametrize("g", [1, 2, 3, 7, 50])
def test_genofreq_selfing_matches_reference_loop(g):
    rng = np.random.default_rng(0)
    p0, p1 = rng.uniform(0.05, 0.95, 2)
    got_hom = float(lk.genofreq_selfing(jnp.float32(p0), jnp.float32(p1),
                                        jnp.asarray(True), jnp.float32(g)))
    got_het = float(lk.genofreq_selfing(jnp.float32(p0), jnp.float32(p1),
                                        jnp.asarray(False), jnp.float32(g)))
    assert got_hom == pytest.approx(ref_genofreq(p0, p1, True, g), rel=1e-5)
    assert got_het == pytest.approx(ref_genofreq(p0, p1, False, g), rel=1e-5)


def test_genofreq_sums_to_one_biallelic():
    # Over a biallelic locus the three genotype frequencies must sum to 1
    # for any selfing generation (the invariant poly_geno.c enforces with
    # nrerror aborts for the tetraploid tables).
    p = 0.3
    for g in [1, 2, 5, 50]:
        g = jnp.float32(g)
        aa = lk.genofreq_selfing(jnp.float32(p), jnp.float32(p),
                                 jnp.asarray(True), g)
        bb = lk.genofreq_selfing(jnp.float32(1 - p), jnp.float32(1 - p),
                                 jnp.asarray(True), g)
        ab = lk.genofreq_selfing(jnp.float32(p), jnp.float32(1 - p),
                                 jnp.asarray(False), g)
        assert float(aa + bb + ab) == pytest.approx(1.0, abs=1e-6)


def test_genofreq_inbreeding_sums_to_one():
    p, f = 0.3, 0.42
    aa = lk.genofreq_inbreeding(jnp.float32(p), jnp.float32(p),
                                jnp.asarray(True), jnp.float32(f))
    bb = lk.genofreq_inbreeding(jnp.float32(1 - p), jnp.float32(1 - p),
                                jnp.asarray(True), jnp.float32(f))
    ab = lk.genofreq_inbreeding(jnp.float32(p), jnp.float32(1 - p),
                                jnp.asarray(False), jnp.float32(f))
    assert float(aa + bb + ab) == pytest.approx(1.0, abs=1e-6)


def _brute_site_loglik(spec, data, freq, z, q, gen, rates):
    """Direct per-site loop mirroring log_ld_indv / log_ld_F_* exactly."""
    geno = data.geno3
    valid = np.asarray(data.site_valid)
    freq = np.asarray(freq)
    n, l, p = geno.shape
    out = np.zeros((n, l))
    for i in range(n):
        for j in range(l):
            if not valid[i, j]:
                continue
            a0, a1 = geno[i, j]
            hom = a0 == a1
            if spec.mode in (2, 3) and spec.type_freq == 0:
                pc = [sum(freq[m, j, geno[i, j, c]] * q[i, m]
                          for m in range(spec.n_pops)) for c in range(2)]
                out[i, j] = np.log(ref_genofreq(pc[0], pc[1], hom, gen[i]))
                continue
            z0, z1 = z[i, j]
            p0 = freq[z0, j, a0]
            p1 = freq[z1, j, a1]
            if spec.mode == 1 or z0 != z1:
                out[i, j] = np.log(p0) + np.log(p1) + (0 if hom else np.log(2))
            elif spec.mode in (2, 3):
                out[i, j] = np.log(ref_genofreq(p0, p1, hom, gen[i]))
            else:
                f = rates[z0] if spec.mode == 4 else rates[i]
                out[i, j] = np.log(ref_genofreq_f(p0, p1, hom, f))
    return out


@pytest.mark.parametrize("mode,type_freq", [(1, 1), (2, 1), (2, 0), (3, 1),
                                            (4, 1), (5, 1)])
def test_site_loglik_vs_bruteforce(mode, type_freq):
    rng = np.random.default_rng(1)
    panel = synthetic_panel(n_indv=7, n_loci=11, n_pops=3, n_alleles=3,
                            missing_rate=0.2, seed=2)
    data = panel.data
    spec = ModelSpec(mode=mode, n_pops=3, type_freq=type_freq)
    k, (n, l, p) = 3, data.geno3.shape
    freq = rng.dirichlet(np.ones(3), size=(k, l)).astype(np.float32)
    z = rng.integers(0, k, size=(n, l, p))
    q = rng.dirichlet(np.ones(k), size=n).astype(np.float32)
    gen = rng.integers(1, 10, size=n)
    rates = rng.uniform(0.05, 0.95, size=(k if mode == 4 else n)).astype(
        np.float32)

    got = np.asarray(lk.site_loglik(
        spec, data, jnp.asarray(freq), jnp.asarray(z.transpose(0, 2, 1).reshape(n, p * l)),
        jnp.asarray(q), jnp.asarray(gen), jnp.asarray(rates)))
    want = _brute_site_loglik(spec, data, freq, z, q, gen, rates)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_loglik_matrix_nopop_admix_vs_bruteforce():
    rng = np.random.default_rng(3)
    panel = synthetic_panel(n_indv=5, n_loci=9, n_pops=2, n_alleles=2,
                            missing_rate=0.1, seed=4)
    data = panel.data
    n, l, p = data.geno3.shape
    freq = rng.dirichlet(np.ones(2), size=(2, l)).astype(np.float32)
    got = np.asarray(lk.loglik_matrix_nopop_admix(data, jnp.asarray(freq)))

    geno = data.geno3
    valid = np.asarray(data.site_valid)
    want = np.zeros((n, 2))
    for i in range(n):
        for kk in range(2):
            ld = 0.0
            for j in range(l):
                if not valid[i, j]:
                    continue
                for c in range(p):
                    ld += np.log(freq[kk, j, geno[i, j, c]])
                if geno[i, j, 0] != geno[i, j, 1]:
                    ld += np.log(2)
            want[i, kk] = ld
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
