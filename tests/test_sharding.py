"""Multi-device tests on the virtual 8-CPU mesh: sharded chains + loci must
reproduce the single-device result bit-for-bit (same keys, same math) and
the dryrun entry used by the driver must pass."""

import jax
import numpy as np
import pytest

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.mcmc.driver import run_mcmc
from instruct_jax.parallel.mesh import make_mesh


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


@needs_8
def test_gspmd_sharded_matches_unsharded():
    """mesh_mode='gspmd' keeps the unsharded program (GSPMD partitions it
    from input shardings), so results are bitwise-identical."""
    panel = synthetic_panel(n_indv=12, n_loci=16, n_pops=2, seed=3)
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(n_iter=30, burnin=10, thinning=2, n_chains=4, ckrep=4,
                     nstep_check_empty_cluster=2)
    key = jax.random.key(11)
    ref = run_mcmc(panel.data, spec, sched, key)
    mesh = make_mesh(4, 2)
    got = run_mcmc(panel.data, spec, sched, key, mesh=mesh,
                   mesh_mode="gspmd")
    np.testing.assert_allclose(np.asarray(got.accum.mean.total_ll),
                               np.asarray(ref.accum.mean.total_ll),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.accum.mean.rates),
                               np.asarray(ref.accum.mean.rates), atol=1e-5)


def _recompute_indv_loglik(panel, spec, res, n_ds):
    """Reassemble the final state from the blocked shard layout and
    recompute the per-individual log-lik on the UNSHARDED panel."""
    from instruct_jax.model import likelihood as lk
    from instruct_jax.parallel.loci_shard import unblock_sites

    data = panel.data
    l, p = data.n_loci, data.ploid
    l_pad = -l % n_ds
    z_blk = np.asarray(res.final_state.z)                   # [C, N, p*Lp]
    z_std = unblock_sites(z_blk, n_ds, p)                   # padded std
    c, n = z_std.shape[:2]
    z = (z_std.reshape(c, n, p, l + l_pad)[..., :l]
         .reshape(c, n, p * l))
    freq = np.asarray(res.final_state.freq)[:, :, :l]       # [C, K, L, A]
    out = []
    for ci in range(c):
        gen = (res.final_state.gen[ci] if spec.has_selfing else None)
        rates = (res.final_state.rates[ci]
                 if np.asarray(res.final_state.rates).size else None)
        out.append(np.asarray(lk.per_indv_loglik(
            spec, data, jax.numpy.asarray(freq[ci]),
            jax.numpy.asarray(z[ci]), res.final_state.q[ci], gen, rates)))
    return np.stack(out)


@needs_8
@pytest.mark.parametrize("mode", [1, 2, 4, 5])
def test_data_shardmap_loglik_exact(mode):
    """The psummed per-individual log-lik leaving the sharded run must
    EQUAL the log-lik recomputed from the reassembled final state on the
    unsharded panel — verifies both the collective placement and the
    blocked z layout, for every diploid likelihood family."""
    panel = synthetic_panel(n_indv=9, n_loci=13, n_pops=2, seed=5)
    spec = ModelSpec(mode=mode, n_pops=2)
    sched = Schedule(n_iter=12, burnin=4, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    n_ds = 4
    mesh = make_mesh(2, n_ds)   # L=13 -> padded to 16, 4 loci per shard
    res = run_mcmc(panel.data, spec, sched, jax.random.key(3), mesh=mesh)
    want = _recompute_indv_loglik(panel, spec, res, n_ds)
    np.testing.assert_allclose(np.asarray(res.final_state.loglik_indv),
                               want, rtol=2e-5, atol=2e-5)


@needs_8
def test_data_shardmap_posterior_parity():
    """Sharded trajectories differ by design (shard-folded site PRNG);
    posterior moments must agree statistically with the unsharded run."""
    panel = synthetic_panel(n_indv=40, n_loci=24, n_pops=2, seed=9)
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(n_iter=1200, burnin=400, thinning=2, n_chains=2,
                     ckrep=10, nstep_check_empty_cluster=10)
    key = jax.random.key(1)
    ref = run_mcmc(panel.data, spec, sched, key)
    got = run_mcmc(panel.data, spec, sched, key, mesh=make_mesh(2, 4))
    s_ref = np.sort(np.asarray(ref.accum.mean.rates), axis=-1)
    s_got = np.sort(np.asarray(got.accum.mean.rates), axis=-1)
    np.testing.assert_allclose(s_got.mean(0), s_ref.mean(0), atol=0.12)
    ll_ref = np.asarray(ref.accum.mean.total_ll).mean()
    ll_got = np.asarray(got.accum.mean.total_ll).mean()
    assert abs(ll_got - ll_ref) / abs(ll_ref) < 0.02


@needs_8
def test_data_shardmap_checkpoint_resume(tmp_path):
    """Segmented + checkpointed sharded run must equal the single-shot
    sharded run bitwise (counter-based keys; zcounts recomputed on restore
    through the shard-mapped recount)."""
    panel = synthetic_panel(n_indv=8, n_loci=12, n_pops=2, seed=6)
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(n_iter=20, burnin=6, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    key = jax.random.key(5)
    mesh = make_mesh(2, 4)
    ref = run_mcmc(panel.data, spec, sched, key, mesh=mesh)
    ck = str(tmp_path / "ck")
    run_mcmc(panel.data, spec, sched, key, mesh=mesh, checkpoint_dir=ck,
             checkpoint_every=8)
    # drop everything after step 8 to simulate a crash, then resume: the
    # continuation must replay steps 8..20 onto the restored state
    import os
    import shutil
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
                               np.asarray(ref.accum.mean.rates), atol=1e-5)


@needs_8
def test_dryrun_multichip():
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(8)


def test_entry_compiles():
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import entry
    fn, args = entry()
    out = jax.jit(fn).lower(*args).compile()
    res = out(*args)
    assert np.isfinite(float(res.loglik_total))


@needs_8
def test_chain_shardmap_matches_unsharded():
    # Pure chain-parallel mesh (data axis = 1) takes the explicit
    # shard_map path (each device runs whole chains locally) and must
    # reproduce the single-device trajectories bit-for-bit.
    panel = synthetic_panel(n_indv=10, n_loci=12, n_pops=2, seed=4)
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(n_iter=24, burnin=8, thinning=2, n_chains=8, ckrep=4,
                     nstep_check_empty_cluster=2)
    key = jax.random.key(7)
    ref = run_mcmc(panel.data, spec, sched, key)
    got = run_mcmc(panel.data, spec, sched, key, mesh=make_mesh(8, 1))
    np.testing.assert_allclose(np.asarray(got.accum.mean.total_ll),
                               np.asarray(ref.accum.mean.total_ll),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.accum.mean.rates),
                               np.asarray(ref.accum.mean.rates), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.final_state.loglik_total),
                               np.asarray(ref.final_state.loglik_total),
                               rtol=1e-5)


@needs_8
def test_use_pallas_with_gspmd_data_shards_raises():
    """Under mesh_mode='gspmd', use_pallas=True + a sharded data axis must
    fail with a clear error, not a GSPMD partitioning failure (ADVICE r1).
    (mesh_mode='auto' supports the combination via the shard_map path.)"""
    panel = synthetic_panel(n_indv=8, n_loci=16, n_pops=2, seed=4)
    spec = ModelSpec(mode=2, n_pops=2, use_pallas=True)
    sched = Schedule(n_iter=6, burnin=2, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    mesh = make_mesh(1, 8)
    with pytest.raises(ValueError, match="use_pallas"):
        run_mcmc(panel.data, spec, sched, jax.random.key(0), mesh=mesh,
                 mesh_mode="gspmd")
