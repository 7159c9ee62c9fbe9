"""Diagnostics: the batched on-device ESS must reproduce the scalar
Geyer initial-positive-sequence estimator, and GR must match its closed
form."""

import numpy as np

from instruct_jax.diagnostics import (effective_sample_size,
                                      effective_sample_size_batch,
                                      gelman_rubin)


def _ess_reference(trace):
    """Direct numpy transcription of the Geyer estimator (the pre-batched
    implementation) for cross-checking."""
    x = np.asarray(trace, dtype=np.float64)
    n = x.size
    x = x - x.mean()
    if x.var() == 0:
        return float(n)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n] / n
    rho = acov / acov[0]
    s, t = 0.0, 1
    while t + 1 <= n - 2:
        pair = rho[t] + rho[t + 1]
        if pair <= 0:
            break
        s += pair
        t += 2
    return float(min(n / (1.0 + 2.0 * s), n))


def _ar1(rng, n, phi):
    x = np.zeros(n)
    for i in range(1, n):
        x[i] = phi * x[i - 1] + rng.standard_normal()
    return x


def test_batched_ess_matches_scalar_geyer():
    rng = np.random.default_rng(0)
    traces = np.stack([_ar1(rng, 500, phi) for phi in
                       [0.0, 0.5, 0.9, -0.3, 0.99]])
    got = np.asarray(effective_sample_size_batch(traces))
    want = np.array([_ess_reference(t) for t in traces])
    np.testing.assert_allclose(got, want, rtol=2e-3)
    # iid chain: ESS ~ n; sticky chain: much less
    assert got[0] > 350 and got[2] < 100


def test_scalar_wrapper_and_constant_trace():
    rng = np.random.default_rng(1)
    t = _ar1(rng, 300, 0.7)
    assert abs(effective_sample_size(t) - _ess_reference(t)) < 2.0
    assert effective_sample_size(np.ones(50)) == 50.0
    assert effective_sample_size(np.ones(3)) == 3.0


def test_gelman_rubin_identical_chains():
    rng = np.random.default_rng(2)
    a = rng.standard_normal(200)
    gr_same = float(gelman_rubin(np.stack([a, a + 1e-7])))
    assert gr_same < 1.01
    gr_far = float(gelman_rubin(np.stack([a, a + 10.0])))
    assert gr_far > 1.1
