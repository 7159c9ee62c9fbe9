"""Rao-Blackwellized G marginalization (ModelSpec.marginalize_g): the
per-individual curve table vs brute force, the truncated-geometric prior,
the exact G conditional, and posterior agreement with the sampled-G chain
(modes 2 and 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.mcmc import marg_g as mg
from instruct_jax.mcmc.driver import run_mcmc
from instruct_jax.mcmc.step import build_step_parts
from instruct_jax.model import likelihood as lk


def _rand_state(seed, n_pops, data):
    rng = np.random.default_rng(seed)
    n, l, p = data.geno3.shape
    a = data.max_alleles
    freq = jnp.asarray(rng.dirichlet(np.ones(a), size=(n_pops, l)),
                       jnp.float32)
    z = jnp.asarray(rng.integers(0, n_pops, (n, l * p)))
    return freq, z


def test_gtable_matches_brute_force():
    # gtable rows differ from per_indv_loglik(g) by a g-independent
    # constant, so differences across g must match exactly.
    panel = synthetic_panel(n_indv=17, n_loci=30, n_pops=2, seed=4,
                            n_alleles=3, missing_rate=0.1)
    data = panel.data
    freq, z = _rand_state(0, 2, data)
    spec = ModelSpec(mode=2, n_pops=2, gen_cap=12)
    gtable = np.asarray(mg.selfing_gtable(data, freq, z, 12))
    n = data.n_indv
    base = None
    for g in [1, 2, 5, 12]:
        gen = jnp.full((n,), g, jnp.int32)
        ll = np.asarray(lk.per_indv_loglik(spec, data, freq, z, None, gen,
                                           None))
        if base is None:
            base = ll - gtable[:, g - 1]
        else:
            np.testing.assert_allclose(gtable[:, g - 1] + base, ll,
                                       rtol=1e-4, atol=1e-3)


def test_log_geom_trunc_normalized():
    cap = 50
    for s in [1e-8, 0.01, 0.5, 0.95, 0.9999, 1 - 1e-8]:
        row = np.asarray(mg.log_geom_trunc(jnp.asarray([s]), cap))[0]
        np.testing.assert_allclose(np.exp(row).sum(), 1.0, rtol=1e-4)
    # plain-geometric shape at moderate s
    row = np.asarray(mg.log_geom_trunc(jnp.asarray([0.3]), cap))[0]
    np.testing.assert_allclose(row[1] - row[0], np.log(0.3), rtol=1e-5)


def test_sample_gen_marginal_distribution():
    # With a flat likelihood curve the draw must follow the truncated
    # geometric prior exactly.
    cap, s, n = 8, 0.6, 4000
    gtable = jnp.zeros((n, cap))
    sbar = jnp.full((n,), s)
    gen = np.asarray(mg.sample_gen_marginal(jax.random.key(0), gtable,
                                            sbar, cap))
    probs = np.exp(np.asarray(mg.log_geom_trunc(jnp.asarray([s]), cap))[0])
    hist = np.bincount(gen - 1, minlength=cap) / n
    np.testing.assert_allclose(hist, probs, atol=4.0 / np.sqrt(n))


@pytest.mark.parametrize("mode", [2, 3])
def test_marginal_vs_sampled_posterior_agreement(mode):
    panel = synthetic_panel(n_indv=60, n_loci=120, n_pops=2,
                            selfing_rates=np.array([0.15, 0.75]),
                            admixture_alpha=0.3, seed=9)
    sched = Schedule(n_iter=1500, burnin=700, thinning=4, n_chains=2,
                     ckrep=50, nstep_check_empty_cluster=100)
    out = {}
    for name, flag in [("marg", True), ("gibbs", False)]:
        spec = ModelSpec(mode=mode, n_pops=2, marginalize_g=flag)
        res = run_mcmc(panel.data, spec, sched, jax.random.key(3))
        rates = np.asarray(res.posterior_mean.rates)      # [C, R]
        ll = np.asarray(res.posterior_mean.total_ll)
        # align exchangeable cluster labels by sorting (mode 2)
        out[name] = (np.sort(rates, axis=-1).mean(0), ll.mean())
    dr = np.abs(out["marg"][0] - out["gibbs"][0])
    rel_ll = abs(out["marg"][1] - out["gibbs"][1]) / abs(out["gibbs"][1])
    tol = 0.08 if mode == 2 else 0.15   # per-individual S is noisier
    assert dr.max() < tol, (out, dr)
    assert rel_ll < 5e-3


def test_marginalize_g_validation():
    panel = synthetic_panel(n_indv=8, n_loci=6, n_pops=2, seed=0)
    with pytest.raises(ValueError, match="selfing modes"):
        build_step_parts(ModelSpec(mode=4, n_pops=2, marginalize_g=True),
                         panel.data)
    with pytest.raises(ValueError, match="structure-way"):
        build_step_parts(ModelSpec(mode=2, n_pops=2, marginalize_g=True,
                                   type_freq=0), panel.data)
