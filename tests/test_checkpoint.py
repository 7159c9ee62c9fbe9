"""Checkpoint/resume: a run interrupted at a checkpoint boundary must
resume to *bitwise* the same posterior moments as the uninterrupted run
(driver docstring contract)."""

import shutil

import jax
import numpy as np

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.mcmc.driver import run_mcmc

SCHED = Schedule(n_iter=60, burnin=20, thinning=2, n_chains=2, ckrep=5,
                 nstep_check_empty_cluster=5)


def test_checkpoint_resume_bitwise(tmp_path):
    panel = synthetic_panel(n_indv=10, n_loci=8, n_pops=2, seed=3)
    spec = ModelSpec(mode=2, n_pops=2)
    key = jax.random.key(12)

    straight = run_mcmc(panel.data, spec, SCHED, key)

    # checkpointed run, all segments in one process
    d1 = tmp_path / "ck1"
    ck = run_mcmc(panel.data, spec, SCHED, key, checkpoint_dir=str(d1),
                  checkpoint_every=25)
    np.testing.assert_array_equal(np.asarray(ck.accum.mean.total_ll),
                                  np.asarray(straight.accum.mean.total_ll))
    np.testing.assert_array_equal(np.asarray(ck.accum.mean.rates),
                                  np.asarray(straight.accum.mean.rates))

    # simulate a crash: run once to completion, delete the final checkpoint
    # so the latest is mid-run, then "resume"
    d2 = tmp_path / "ck2"
    run_mcmc(panel.data, spec, SCHED, key, checkpoint_dir=str(d2),
             checkpoint_every=25)
    shutil.rmtree(d2 / "step_000000000060")
    shutil.rmtree(d2 / "step_000000000050")
    resumed = run_mcmc(panel.data, spec, SCHED, key, checkpoint_dir=str(d2),
                       checkpoint_every=25)
    np.testing.assert_array_equal(np.asarray(resumed.accum.mean.total_ll),
                                  np.asarray(straight.accum.mean.total_ll))
    np.testing.assert_array_equal(np.asarray(resumed.accum.mean.q),
                                  np.asarray(straight.accum.mean.q))


def test_checkpoint_format_v2_field_path_keys(tmp_path):
    """Leaves are keyed by field path with a version marker, so adding or
    reordering state fields does not silently shift leaves (ADVICE r1)."""
    import json

    from instruct_jax import checkpoint as ckpt

    panel = synthetic_panel(n_indv=6, n_loci=5, n_pops=2, seed=1)
    spec = ModelSpec(mode=2, n_pops=2)
    d = tmp_path / "ck"
    run_mcmc(panel.data, spec, SCHED, jax.random.key(5),
             checkpoint_dir=str(d), checkpoint_every=30)
    step = ckpt.latest_step(str(d))
    meta = json.load(open(ckpt._meta_path(str(d), step)))
    assert meta["format_version"] == ckpt.FORMAT_VERSION >= 2
    assert any("freq" in k for k in meta["keys"])
    assert any("rates" in k for k in meta["keys"])


def test_checkpoint_legacy_v1_restorable(tmp_path):
    """A round-1 checkpoint (positional leaf_<i> keys, no meta file) still
    restores when the pytree structure matches."""
    from instruct_jax import checkpoint as ckpt

    payload = ({"a": np.arange(4.0), "b": np.int32(7)},
               np.ones((2, 3), np.float32))
    # legacy writer: positional keys, no meta
    import orbax.checkpoint as ocp
    leaves, _ = jax.tree.flatten(payload)
    legacy = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    w = ocp.StandardCheckpointer()
    w.save(ckpt._ckpt_path(str(tmp_path), 10), legacy, force=True)
    w.wait_until_finished()

    template = jax.tree.map(np.zeros_like, payload)
    got = ckpt.restore_checkpoint(str(tmp_path), 10, template)
    for a, b in zip(jax.tree.leaves(got), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_v2_tetra_checkpoint_rejected(tmp_path):
    """A v2 checkpoint with a tetraploid geno leaf is refused: v2 stored
    the latents copy-interleaved, v3 is copy-major — a silent restore
    would permute allele copies."""
    import json

    import orbax.checkpoint as ocp
    import pytest

    from instruct_jax import checkpoint as ckpt

    payload = {"geno": np.zeros((3, 8), np.int8),
               "rates": np.ones(2, np.float32)}
    w = ocp.StandardCheckpointer()
    w.save(ckpt._ckpt_path(str(tmp_path), 5), payload, force=True)
    w.wait_until_finished()
    with open(ckpt._meta_path(str(tmp_path), 5), "w") as fh:
        json.dump({"format_version": 2, "step": 5,
                   "keys": list(payload)}, fh)
    with pytest.raises(ValueError, match="copy-interleaved"):
        ckpt.restore_checkpoint(str(tmp_path), 5,
                                jax.tree.map(np.zeros_like, payload))


def test_resume_recomputes_zcounts(tmp_path):
    """zcounts is derived state: a resumed run must recompute it from the
    restored z, not trust the saved value (fused/XLA path transfer)."""
    from instruct_jax import checkpoint as ckpt
    from instruct_jax.mcmc import updates as up

    panel = synthetic_panel(n_indv=8, n_loci=6, n_pops=2, seed=9)
    spec = ModelSpec(mode=2, n_pops=2)
    d = tmp_path / "ck"
    run_mcmc(panel.data, spec, SCHED, jax.random.key(2),
             checkpoint_dir=str(d), checkpoint_every=30)

    # corrupt the saved zcounts of the mid-run checkpoint
    import shutil as sh
    sh.rmtree(d / "step_000000000060")
    step = ckpt.latest_step(str(d))
    from instruct_jax.mcmc.accumulators import init_accum
    from instruct_jax.mcmc.state import init_state
    tmpl_state = jax.vmap(
        lambda c: init_state(jax.random.fold_in(jax.random.key(2), c),
                             spec, panel.data))(np.arange(2))
    tmpl_acc = jax.vmap(
        lambda _: init_accum(spec, SCHED, panel.data, False))(np.arange(2))
    kdata = jax.random.key_data(jax.vmap(
        lambda c: jax.random.fold_in(jax.random.key(2), c))(np.arange(2)))
    states, accums, kd = ckpt.restore_checkpoint(
        str(d), step, (tmpl_state, tmpl_acc, kdata))
    bad = states._replace(zcounts=states.zcounts + 123.0)
    ckpt.save_checkpoint(str(d), step, (bad, accums, kd))

    resumed = run_mcmc(panel.data, spec, SCHED, jax.random.key(2),
                       checkpoint_dir=str(d), checkpoint_every=30)
    straight = run_mcmc(panel.data, spec, SCHED, jax.random.key(2))
    np.testing.assert_array_equal(np.asarray(resumed.accum.mean.total_ll),
                                  np.asarray(straight.accum.mean.total_ll))
    # The corrupted value must have been replaced by a recount of the
    # restored z (the XLA path never rewrites zcounts, so the final state
    # still holds exactly what the restore computed).
    want = jax.vmap(lambda z, zz: up.allele_pop_counts(
        spec, panel.data, z, zz))(states.z, states.zz)
    np.testing.assert_allclose(np.asarray(resumed.final_state.zcounts),
                               np.asarray(want), atol=1e-4)


def test_checkpointed_run_retries_unhealthy(tmp_path, monkeypatch):
    """A chain flagged unhealthy in a CHECKPOINTED run must be rerun with a
    fresh key in its own checkpoint namespace (VERDICT r4 weak #3: the old
    `checkpoint_dir is None` guard silently kept bad chains exactly in the
    long production runs where the reference's chn-- retry matters,
    InStruct.c:185-190)."""
    from instruct_jax.mcmc import driver as drv

    panel = synthetic_panel(n_indv=10, n_loci=8, n_pops=2, seed=3)
    spec = ModelSpec(mode=2, n_pops=2)
    key = jax.random.key(12)

    clean = run_mcmc(panel.data, spec, SCHED, key)
    real_flags = drv.unhealthy_flags
    calls = {"n": 0}

    def flaky_flags(state, accum):
        calls["n"] += 1
        if calls["n"] == 1:                 # first pass: chain 0 "fails"
            return np.array([True, False])
        return real_flags(state, accum)

    monkeypatch.setattr(drv, "unhealthy_flags", flaky_flags)
    d = tmp_path / "ck"
    res = run_mcmc(panel.data, spec, SCHED, key, checkpoint_dir=str(d),
                   checkpoint_every=25)
    assert res.n_retries == 1
    # the retry pass ran under its own namespace
    assert (d / "retry-1").exists()
    ll = np.asarray(res.accum.mean.total_ll)
    ll_clean = np.asarray(clean.accum.mean.total_ll)
    # chain 0 was rerun with a fresh key -> different trajectory;
    # chain 1 replayed its original key -> bitwise identical
    assert ll[0] != ll_clean[0]
    np.testing.assert_array_equal(ll[1], ll_clean[1])


def test_jsonl_log_carries_full_rates(tmp_path):
    """The JSONL progress log records the complete per-chain rates matrix
    (print_info parity, mcmc.c:1267-1316 prints every S value; the old
    code dropped rates past 256 values)."""
    import json

    panel = synthetic_panel(n_indv=300, n_loci=8, n_pops=2, seed=3)
    spec = ModelSpec(mode=3, n_pops=2)       # per-individual S: 300 rates
    log = tmp_path / "log.jsonl"
    run_mcmc(panel.data, spec, SCHED, jax.random.key(2),
             progress_every=30, jsonl_log=str(log))
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert lines, "no progress records written"
    rates = np.asarray(lines[-1]["rates"])
    assert rates.shape == (2, 300)
    assert np.isfinite(rates).all()
