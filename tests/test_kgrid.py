"""Padded (chain x K) K-selection grid: masked replicas at K_max shapes
must reproduce the native-K posteriors, never leak mass onto inactive pop
slots, and the grid infer_k must agree with the sequential sweep."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.kselect import infer_k
from instruct_jax.mcmc.driver import run_mcmc


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(n_indv=50, n_loci=100, n_pops=2,
                           selfing_rates=np.array([0.15, 0.75]),
                           admixture_alpha=0.2, seed=13)


SCHED = Schedule(n_iter=1200, burnin=600, thinning=3, n_chains=2,
                 ckrep=50, nstep_check_empty_cluster=100)


def test_padded_replica_matches_native(panel):
    # K=2 native vs K=2 active inside K_max=4 padding: same posterior.
    spec2 = ModelSpec(mode=2, n_pops=2)
    res_nat = run_mcmc(panel.data, spec2, SCHED, jax.random.key(0))
    s_nat = np.sort(np.asarray(res_nat.posterior_mean.rates), -1).mean(0)

    spec4 = ModelSpec(mode=2, n_pops=4)
    active = np.zeros((2, 4), np.float32)
    active[:, :2] = 1.0
    res_pad = run_mcmc(panel.data, spec4, SCHED, jax.random.key(0),
                       active_pops=active)
    q_pad = np.asarray(res_pad.posterior_mean.q)            # [C, N, 4]
    # invariant: EXACTLY zero admixture mass on inactive slots
    assert q_pad[:, :, 2:].max() == 0.0
    s_pad = np.sort(np.asarray(res_pad.posterior_mean.rates)[:, :2],
                    -1).mean(0)
    np.testing.assert_allclose(s_pad, s_nat, atol=0.08)
    ll_nat = np.asarray(res_nat.posterior_mean.total_ll).mean()
    ll_pad = np.asarray(res_pad.posterior_mean.total_ll).mean()
    assert abs(ll_pad - ll_nat) / abs(ll_nat) < 5e-3


def test_grid_infer_k_matches_sequential(panel):
    spec = ModelSpec(mode=2, n_pops=2)
    sched = dataclasses.replace(SCHED, n_iter=800, burnin=400)
    res_g = infer_k(panel.data, spec, sched, jax.random.key(1),
                    n_small=1, n_large=3, grid=True)
    res_s = infer_k(panel.data, spec, sched, jax.random.key(1),
                    n_small=1, n_large=3, grid=False)
    assert res_g.best_k == res_s.best_k == 2
    for k in (1, 2, 3):
        # WAIC per K agrees between grid and sequential within MC noise
        wg, ws = res_g.waic[k].mean(), res_s.waic[k].mean()
        assert abs(wg - ws) / abs(ws) < 0.02, (k, wg, ws)
        # sliced shapes are native-K
        assert res_g.results[k].posterior_mean.q.shape[-1] == k
        assert res_g.results[k].posterior_mean.rates.shape[-1] == k


def test_grid_threads_init_rates(panel):
    spec = ModelSpec(mode=2, n_pops=2)
    sched = dataclasses.replace(SCHED, n_iter=40, burnin=20, ckrep=5,
                                nstep_check_empty_cluster=4)
    init = np.asarray([[0.3, 0.6], [0.2, 0.9]], np.float32)
    res = infer_k(panel.data, spec, sched, jax.random.key(2),
                  n_small=2, n_large=3, grid=True, init_rates=init)
    assert set(res.results) == {2, 3}


def test_padded_replica_matches_native_mode0(panel):
    """Mode 0 (no admixture) in the padded K grid (VERDICT r4 missing #4):
    the per-individual z never selects an inactive slot, and the
    label-invariant posteriors (total log-lik, co-assignment matrix, WAIC)
    match the native-K run."""
    spec2 = ModelSpec(mode=0, n_pops=2)
    res_nat = run_mcmc(panel.data, spec2, SCHED, jax.random.key(0),
                       track_freq=True)

    spec4 = ModelSpec(mode=0, n_pops=4)
    active = np.zeros((2, 4), np.float32)
    active[:, :2] = 1.0
    res_pad = run_mcmc(panel.data, spec4, SCHED, jax.random.key(0),
                       active_pops=active, track_freq=True)
    q_pad = np.asarray(res_pad.posterior_mean.q)            # [C, N, 4]
    assert q_pad[:, :, 2:].max() == 0.0

    ll_nat = np.asarray(res_nat.posterior_mean.total_ll).mean()
    ll_pad = np.asarray(res_pad.posterior_mean.total_ll).mean()
    assert abs(ll_pad - ll_nat) / abs(ll_nat) < 5e-3

    # co-assignment similarity (label-invariant): P(i, j same cluster)
    q_nat = np.asarray(res_nat.posterior_mean.q)            # [C, N, 2]
    co_nat = np.einsum("cik,cjk->ij", q_nat, q_nat) / q_nat.shape[0]
    co_pad = np.einsum("cik,cjk->ij", q_pad, q_pad) / q_pad.shape[0]
    assert np.abs(co_nat - co_pad).mean() < 0.05

    # WAIC (the grid's ranking statistic) agrees too
    w_nat, w_pad = res_nat.waic(), res_pad.waic()
    assert w_nat is not None and w_pad is not None
    assert abs(w_nat.mean() - w_pad.mean()) / abs(w_nat.mean()) < 0.02


def test_grid_infer_k_mode0(panel):
    """A mode-0 K sweep runs as ONE padded compile and recovers the
    generating K (the reference sweeps every mode, InStruct.c:555-577)."""
    spec = ModelSpec(mode=0, n_pops=2)
    sched = dataclasses.replace(SCHED, n_iter=800, burnin=400)
    res = infer_k(panel.data, spec, sched, jax.random.key(1),
                  n_small=1, n_large=3, grid=True)
    assert res.best_k == 2
    for k in (1, 2, 3):
        assert res.waic[k] is not None
        assert res.results[k].posterior_mean.q.shape[-1] == k
