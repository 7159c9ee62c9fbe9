"""Loci sharding of the tetraploid engine (VERDICT r4 missing #2).

The class-uniform layout (loci_shard.tetra_shard_plan) gives every shard
an identical per-allele-count class structure, so one shard_map program
serves all shards; the collective set is the same psum triple as the
diploid path (pop counts, S MH columns, per-individual log-liks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.synthetic import synthetic_tetra_panel
from instruct_jax.mcmc.driver import run_mcmc
from instruct_jax.parallel import loci_shard as ls
from instruct_jax.parallel.mesh import make_mesh
from instruct_jax.tetra import engine as eng

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


def _mixed_class_tetra_data(n=8, l=23, seed=2):
    """A panel whose loci GENUINELY span allele-count classes 2/3/4 with
    counts not divisible by the shard count — synthetic_tetra_panel with
    n_alleles=4 makes every locus quad-allelic, which left the original
    cross-shard assertion vacuous (round-5 self-review finding)."""
    from instruct_jax.data.dataset import make_dataset
    rng = np.random.default_rng(seed)
    n_alleles = rng.choice([2, 3, 4], size=l, p=[0.5, 0.3, 0.2])
    n_alleles[:3] = [2, 3, 4]                 # every class present
    nd = np.minimum(rng.integers(1, 5, size=(n, l)), n_alleles[None, :])
    distinct = np.zeros((n, l, 4), np.int32)
    for i in range(n):
        for j in range(l):
            vals = np.sort(rng.choice(n_alleles[j], size=nd[i, j],
                                      replace=False))
            distinct[i, j, :nd[i, j]] = vals
    return make_dataset(distinct, np.zeros((n, l), bool),
                        n_alleles.astype(np.int32), distinct=distinct,
                        n_distinct=nd)


def test_tetra_shard_plan_class_uniform():
    """On a genuinely mixed-class panel: every shard's local class layout
    (per-column allele count, INCLUDING padding columns) is identical,
    every real locus appears exactly once, and build_tables on each
    shard's local view yields the same class map — the invariant that
    lets shard-0 tables serve every shard of the one traced program."""
    from instruct_jax.config import ModelSpec
    from instruct_jax.tetra import engine as eng

    data = _mixed_class_tetra_data()
    n_shards = 4
    src = ls.tetra_shard_plan(data, n_shards)
    real = src[src >= 0]
    assert sorted(real.tolist()) == list(range(data.n_loci))
    assert (src < 0).any(), "plan must exercise padding columns"

    stacked = ls.stack_loci_tetra(data, n_shards)
    av = np.asarray(stacked.allele_valid).sum(-1)            # [S, L_loc]
    for s in range(1, n_shards):
        np.testing.assert_array_equal(av[s], av[0])

    spec = ModelSpec(mode=2, ploid=4, n_pops=2)

    def class_struct(tab):
        return [(ci, tuple(loci.tolist()), g)
                for ci, loci, g in tab.class_loci]

    ref = None
    for s in range(n_shards):
        local = jax.tree.map(lambda x: x[s], stacked)
        tab = eng.build_tables(spec, local, with_candidates=False)
        cur = (np.asarray(tab.cls).tolist(), class_struct(tab))
        if ref is None:
            ref = cur
        assert cur == ref, f"shard {s} class structure diverges"


@needs_8
def test_tetra_sharded_loglik_exact():
    """The psummed per-individual log-lik leaving the sharded tetra run
    equals the per-shard recomputation from the reassembled final state —
    verifies collective placement and the class-uniform blocked layout,
    on a MIXED-allele-count panel (multiple classes + padding columns)."""
    data = _mixed_class_tetra_data(n=8, l=15, seed=5)
    spec = ModelSpec(mode=2, ploid=4, n_pops=2)
    sched = Schedule(n_iter=10, burnin=4, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    n_ds = 4
    mesh = make_mesh(2, n_ds)
    res = run_mcmc(data, spec, sched, jax.random.key(3), mesh=mesh)

    stacked = ls.stack_loci_tetra(data, n_ds)
    tables = eng.build_tables(spec, ls.local_view(stacked))
    ll_loc = stacked.site_valid.shape[-1]
    st = res.final_state
    c = np.asarray(st.loglik_indv).shape[0]
    want = np.zeros((c, data.n_indv))
    for ci in range(c):
        for s in range(n_ds):
            local = jax.tree.map(lambda x: x[s], stacked)
            freq = jnp.asarray(st.freq)[ci, :, s * ll_loc:(s + 1) * ll_loc]
            freq2 = jnp.asarray(st.freq2)[ci, :,
                                          s * ll_loc:(s + 1) * ll_loc]
            z = jnp.asarray(st.z)[ci][:, s * 4 * ll_loc:(s + 1) * 4 * ll_loc]
            geno = jnp.asarray(st.geno)[ci][:,
                                            s * 4 * ll_loc:(s + 1) * 4 * ll_loc]
            rates = jnp.asarray(st.rates)[ci]
            log_hwe = eng.log_hwe_table(tables, spec, freq, freq2)
            table = eng.selfing_equilibrium(tables, log_hwe, rates)
            site = eng._site_loglik(tables, spec, local, freq, freq2, z,
                                    geno, table)
            want[ci] += np.asarray(site.sum(axis=1))
    np.testing.assert_allclose(np.asarray(st.loglik_indv), want,
                               rtol=2e-5, atol=2e-5)


@needs_8
def test_tetra_sharded_posterior_parity():
    """Sharded trajectories differ by design (shard-folded site PRNG);
    posterior S / log-lik moments must agree with the unsharded run, and
    the sharded WAIC must be finite (model choice works sharded)."""
    panel = synthetic_tetra_panel(n_indv=30, n_loci=24, n_pops=2,
                                  n_alleles=2,
                                  selfing_rates=np.array([0.2, 0.7]),
                                  seed=9)
    spec = ModelSpec(mode=2, ploid=4, n_pops=2)
    sched = Schedule(n_iter=600, burnin=200, thinning=2, n_chains=2,
                     ckrep=10, nstep_check_empty_cluster=10, dic_every=5)
    key = jax.random.key(1)
    ref = run_mcmc(panel.data, spec, sched, key, track_freq=True)
    got = run_mcmc(panel.data, spec, sched, key, track_freq=True,
                   mesh=make_mesh(2, 4))
    s_ref = np.sort(np.asarray(ref.accum.mean.rates), axis=-1)
    s_got = np.sort(np.asarray(got.accum.mean.rates), axis=-1)
    np.testing.assert_allclose(s_got.mean(0), s_ref.mean(0), atol=0.12)
    ll_ref = np.asarray(ref.accum.mean.total_ll).mean()
    ll_got = np.asarray(got.accum.mean.total_ll).mean()
    assert abs(ll_got - ll_ref) / abs(ll_ref) < 0.02
    w_ref, w_got = ref.waic(), got.waic()
    assert w_got is not None and np.isfinite(w_got).all()
    assert abs(w_got.mean() - w_ref.mean()) / abs(w_ref.mean()) < 0.05


@needs_8
def test_tetra_sharded_checkpoint_resume(tmp_path):
    """Segmented + checkpointed sharded tetra run equals the single-shot
    sharded run bitwise (counter-based keys; blocked z/geno layout round-
    trips through orbax)."""
    import os
    import shutil

    panel = synthetic_tetra_panel(n_indv=6, n_loci=9, n_pops=2,
                                  n_alleles=2, seed=6)
    spec = ModelSpec(mode=2, ploid=4, n_pops=2)
    sched = Schedule(n_iter=20, burnin=6, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    key = jax.random.key(5)
    mesh = make_mesh(2, 4)
    ref = run_mcmc(panel.data, spec, sched, key, mesh=mesh)
    ck = str(tmp_path / "ck")
    run_mcmc(panel.data, spec, sched, key, mesh=mesh, checkpoint_dir=ck,
             checkpoint_every=8)
    for name in os.listdir(ck):
        step = int(name[5:17]) if name.startswith("step_") else 0
        if step > 8:
            p = os.path.join(ck, name)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    got = run_mcmc(panel.data, spec, sched, key, mesh=mesh,
                   checkpoint_dir=ck, checkpoint_every=8)
    np.testing.assert_allclose(np.asarray(got.accum.mean.total_ll),
                               np.asarray(ref.accum.mean.total_ll),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.accum.mean.rates),
                               np.asarray(ref.accum.mean.rates),
                               atol=1e-5)
