"""End-to-end driver tests: every mode runs, accumulates sane moments, and
mode-2 posterior recovers synthetic ground truth (survey §4 item 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.diagnostics import gelman_rubin
from instruct_jax.mcmc.driver import run_mcmc


SCHED = Schedule(n_iter=60, burnin=20, thinning=2, n_chains=2, ckrep=5,
                 nstep_check_empty_cluster=5)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 5])
def test_all_modes_run(mode):
    panel = synthetic_panel(n_indv=12, n_loci=10, n_pops=2, missing_rate=0.1,
                            seed=mode)
    spec = ModelSpec(mode=mode, n_pops=2)
    res = run_mcmc(panel.data, spec, SCHED, jax.random.key(0))
    assert int(res.accum.count[0]) == SCHED.n_stored
    total = np.asarray(res.accum.mean.total_ll)
    assert np.isfinite(total).all() and (total < 0).all()
    if mode != 0:
        q = np.asarray(res.accum.mean.q)
        np.testing.assert_allclose(q.sum(-1), 1.0, atol=1e-3)
    if mode in (2, 4):
        assert res.accum.mean.rates.shape == (2, 2)
    if mode in (3, 5):
        assert res.accum.mean.rates.shape == (2, 12)
    var = res.posterior_var
    assert np.all(np.asarray(var.total_ll) >= -1e-3)
    assert np.isfinite(res.dic()).all()


@pytest.mark.parametrize("back_refl,type_freq", [(0, 1), (1, 0)])
def test_mode2_variants_run(back_refl, type_freq):
    panel = synthetic_panel(n_indv=10, n_loci=8, n_pops=2, seed=11)
    spec = ModelSpec(mode=2, n_pops=2, back_refl=back_refl,
                     type_freq=type_freq)
    res = run_mcmc(panel.data, spec, SCHED, jax.random.key(1))
    assert np.isfinite(np.asarray(res.accum.mean.total_ll)).all()


def test_mode2_recovers_selfing_rates():
    # Strong signal: clearly separated pops with very different selfing.
    panel = synthetic_panel(n_indv=60, n_loci=60, n_pops=2, n_alleles=2,
                            selfing_rates=np.array([0.05, 0.9]),
                            admixture_alpha=0.05, seed=42)
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(n_iter=600, burnin=200, thinning=2, n_chains=2,
                     ckrep=50, nstep_check_empty_cluster=20)
    res = run_mcmc(panel.data, spec, sched, jax.random.key(3))
    s = np.sort(np.asarray(res.accum.mean.rates), axis=-1)
    # both chains should find one low- and one high-selfing cluster
    assert (s[:, 0] < 0.45).all(), s
    assert (s[:, 1] > 0.55).all(), s


def test_convergence_trace_and_gr():
    panel = synthetic_panel(n_indv=15, n_loci=12, n_pops=2, seed=5)
    spec = ModelSpec(mode=2, n_pops=2)
    res = run_mcmc(panel.data, spec, SCHED, jax.random.key(4))
    convg = np.asarray(res.accum.convg_ld)
    assert convg.shape == (2, SCHED.ckrep)
    assert np.isfinite(convg).all() and (convg != 0).all()
    gr = float(gelman_rubin(convg))
    assert np.isfinite(gr) and gr > 0


def test_determinism():
    panel = synthetic_panel(n_indv=8, n_loci=6, n_pops=2, seed=6)
    spec = ModelSpec(mode=2, n_pops=2)
    r1 = run_mcmc(panel.data, spec, SCHED, jax.random.key(7))
    r2 = run_mcmc(panel.data, spec, SCHED, jax.random.key(7))
    np.testing.assert_array_equal(np.asarray(r1.accum.mean.total_ll),
                                  np.asarray(r2.accum.mean.total_ll))
    np.testing.assert_array_equal(np.asarray(r1.accum.mean.rates),
                                  np.asarray(r2.accum.mean.rates))


def test_s_subsweeps_preserve_posterior():
    """Extra inner S-MH sweeps (ModelSpec.s_subsweeps) target the same
    posterior — the strong-signal recovery must hold and agree with the
    single-sweep run."""
    panel = synthetic_panel(n_indv=60, n_loci=60, n_pops=2, n_alleles=2,
                            selfing_rates=np.array([0.05, 0.9]),
                            admixture_alpha=0.05, seed=42)
    sched = Schedule(n_iter=600, burnin=200, thinning=2, n_chains=2,
                     ckrep=50, nstep_check_empty_cluster=20)
    res1 = run_mcmc(panel.data, ModelSpec(mode=2, n_pops=2), sched,
                    jax.random.key(3))
    res8 = run_mcmc(panel.data, ModelSpec(mode=2, n_pops=2, s_subsweeps=8),
                    sched, jax.random.key(3))
    s1 = np.sort(np.asarray(res1.accum.mean.rates), axis=-1)
    s8 = np.sort(np.asarray(res8.accum.mean.rates), axis=-1)
    assert (s8[:, 0] < 0.45).all() and (s8[:, 1] > 0.55).all(), s8
    np.testing.assert_allclose(s8.mean(0), s1.mean(0), atol=0.12)


def test_structure_way_generator_recovery():
    """The sweep recovers S on data generated from the EXACT structure-way
    model (selfing collapse applied only at same-z het sites).  This pins
    the mutual calibration of the sweep's approximations (per-copy z draw
    + conjugate P count update, docs/DESIGN.md round-5 note): an exact
    joint-z kernel spliced into this sweep measured S0 ~ 0.35 on the same
    panel, so a regression here means a kernel change broke the
    calibration, not a tolerance blip."""
    import numpy as np

    from instruct_jax.data.dataset import make_dataset

    def structure_way_panel(n, l, k, s_rates, alpha, seed):
        rng = np.random.default_rng(seed)
        freq = rng.dirichlet(np.ones(2), size=(k, l))
        q = rng.dirichlet(np.full(k, alpha), size=n)
        sbar = q @ np.asarray(s_rates)
        gen = np.minimum(rng.geometric(np.clip(1.0 - sbar, 1e-9, 1.0)),
                         50)
        geno = np.zeros((n, l, 2), np.int32)
        for i in range(n):
            z = rng.choice(k, size=(l, 2), p=q[i])
            a = np.zeros((l, 2), np.int64)
            for c in range(2):
                pf = freq[z[:, c], np.arange(l)]
                a[:, c] = (rng.random(l)[:, None] > pf.cumsum(1)).sum(1)
            same = z[:, 0] == z[:, 1]
            p_surv = 0.5 ** (gen[i] - 1)
            collapse = same & (rng.random(l) > p_surv)
            pick = rng.integers(0, 2, l)
            a[collapse, 0] = a[collapse, pick[collapse]]
            a[collapse, 1] = a[collapse, 0]
            geno[i] = a
        return make_dataset(geno, np.zeros((n, l), bool),
                            np.full(l, 2, np.int32))

    data = structure_way_panel(100, 100, 2, [0.1, 0.8], 0.2, seed=1)
    sched = Schedule(n_iter=3000, burnin=1500, thinning=5, n_chains=2,
                     ckrep=100, nstep_check_empty_cluster=20)
    spec = ModelSpec(mode=2, n_pops=2, use_pallas=False)
    res = run_mcmc(data, spec, sched, jax.random.key(0))
    s = np.sort(np.asarray(res.accum.mean.rates), -1).mean(0)
    np.testing.assert_allclose(s, [0.1, 0.8], atol=0.1)
