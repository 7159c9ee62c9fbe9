"""Chain driver: vmapped chains, `lax.scan` step loop, retry-on-empty-cluster,
checkpoint/resume.

Replaces the sequential chain loop of the reference (InStruct.c:182-193):
all chains advance in lockstep as a vmapped leading axis, shardable over a
device mesh.  A chain flagged by the empty-cluster guard is rerun with a
fresh key, mirroring the `chn--` retry (InStruct.c:185-190) — unflagged
chains are replayed with their original keys so the retry loop is
deterministic and recompile-free.

With ``checkpoint_dir`` the run is segmented: the (states, accumulators)
pytree is saved every ``checkpoint_every`` iterations and a fresh call with
the same arguments resumes from the latest checkpoint bitwise (step keys
are counter-based, so the resumed trajectory equals the uninterrupted one).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.dataset import Dataset
from instruct_jax.mcmc import updates as up
from instruct_jax.mcmc.accumulators import (ChainAccum, accum_update,
                                            extract_stats, init_accum)
from instruct_jax.mcmc.state import McmcState, init_state
from instruct_jax.mcmc.step import build_step


@dataclasses.dataclass
class RunResult:
    """Posterior summaries for all chains (leading axis = chain)."""

    accum: ChainAccum          # streaming moments per chain
    final_state: McmcState     # last draw per chain (for resume / debugging)
    n_retries: int
    plugin_ll: Optional[np.ndarray] = None  # per-chain Z-marginalized
    #   log-lik at the posterior means (the plug-in term of the corrected
    #   DIC); filled when the run tracked P (track_freq) on a diploid model

    @property
    def posterior_mean(self):
        return self.accum.mean

    @property
    def posterior_var(self):
        return jax.tree.map(lambda m2, m: m2 - m * m,
                            self.accum.mean_sq, self.accum.mean)

    def dic_reference(self) -> np.ndarray:
        """Per-chain DIC exactly as the reference computes it
        (print_lkh_to_file, result_analysis.c:403-411):
        -4 E[logL] + 2 sum_j E[logL_j].  Because the reference's "plug-in"
        term is itself the posterior-mean log-lik, this degenerates to
        -2 E[logL] — no complexity penalty (survey §2.1 quirk list).
        Kept as a separate column for binary comparison."""
        mean_total = np.asarray(self.accum.mean.total_ll)
        mean_indv = np.asarray(self.accum.mean.indv_ll).sum(axis=-1)
        return -4.0 * mean_total + 2.0 * mean_indv

    def dic(self) -> np.ndarray:
        """Per-chain *corrected* DIC (the documented intent of
        result_analysis.c:403-411, per SURVEY.md §2.1):

            DIC = Dbar + pD = -4 E[logL] + 2 logL(theta_bar)

        with both terms evaluated on the same pointwise-likelihood focus
        (step.build_marg_loglik: Z-marginalized for diploid modes,
        (z, geno)-conditional for the tetraploid engine) — E[logL] from
        the streaming ll_marg moment, logL(theta_bar) at the posterior
        means.  Falls back to the reference-compatible formula only when
        the plug-in is unavailable (the run did not track P)."""
        if self.plugin_ll is None:
            return self.dic_reference()
        dbar = -2.0 * np.asarray(self.accum.mean.ll_marg).sum(axis=-1)
        dplug = -2.0 * np.asarray(self.plugin_ll)
        return 2.0 * dbar - dplug

    def p_d(self) -> Optional[np.ndarray]:
        """Effective number of parameters pD = Dbar - D(theta_bar)
        (Spiegelhalter et al. 2002); None when no plug-in is available."""
        if self.plugin_ll is None:
            return None
        dbar = -2.0 * np.asarray(self.accum.mean.ll_marg).sum(axis=-1)
        dplug = -2.0 * np.asarray(self.plugin_ll)
        return dbar - dplug

    def waic(self) -> Optional[np.ndarray]:
        """Per-chain WAIC (Watanabe 2010):

            WAIC = -2 sum_i ( log E[p(y_i|theta)] - Var[log p(y_i|theta)] )

        computed from the streaming per-individual log-mean-exp (lppd) and
        moments (pwaic_2) of the Z-marginalized likelihood.  Every term is
        a posterior expectation of a label-INVARIANT quantity, so — unlike
        any DIC plug-in — it is immune to within-chain label switching.
        Mixture models are singular, where DIC's pD collapses exactly when
        redundant clusters wander (Watanabe's regime); K-selection
        therefore ranks on WAIC (kselect.py), with both DICs reported
        alongside.  The tetraploid engine uses the (z, geno)-conditional
        focus (see step.build_marg_loglik), so `-ik -p 4` sweeps rank on
        a real information criterion too."""
        lme = np.asarray(self.accum.lme_indv)
        if lme.size == 0 or not np.isfinite(lme).all():
            return None
        pw = self.p_waic()
        return -2.0 * lme.sum(axis=-1) + 2.0 * pw

    def p_waic(self) -> Optional[np.ndarray]:
        """pwaic_2 = sum_i Var[log p(y_i|theta)] from the centered Welford
        accumulator (population variance over the stored subsample)."""
        lme = np.asarray(self.accum.lme_indv)
        if lme.size == 0 or not np.isfinite(lme).all():
            return None
        count = np.maximum(np.asarray(self.accum.count, np.float64), 1.0)
        pw = np.asarray(self.accum.m2_ll_marg) / count[..., None]
        return pw.sum(axis=-1)

    def waic_indv(self) -> Optional[np.ndarray]:
        """Per-chain, per-individual WAIC contributions [-2 (lppd_i -
        pwaic_i)]; WAIC is their sum, and their spread gives its Monte-
        Carlo-free sampling SE (Vehtari, Gelman & Gabry 2017)."""
        lme = np.asarray(self.accum.lme_indv)
        if lme.size == 0 or not np.isfinite(lme).all():
            return None
        count = np.maximum(np.asarray(self.accum.count, np.float64), 1.0)
        pw = np.asarray(self.accum.m2_ll_marg) / count[..., None]
        return -2.0 * (lme - pw)

    def waic_se(self) -> Optional[float]:
        """Standard error of WAIC: sqrt(N) * sd over individuals of the
        chain-averaged per-individual contributions."""
        wi = self.waic_indv()
        if wi is None:
            return None
        n = wi.shape[-1]
        return float(np.sqrt(n) * wi.mean(axis=0).std())


def _host(x) -> np.ndarray:
    """Fetch an array to host numpy, allgathering across processes when it
    spans hosts (multi-host runs, parallel/distributed.py): np.asarray on a
    non-fully-addressable jax.Array raises."""
    if hasattr(x, "is_fully_addressable") and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def unhealthy_flags(state, accum) -> np.ndarray:
    """Per-chain failure flags: the reference's empty-cluster guard
    (mcmc.c:1944-1974) plus numeric health — a chain whose stored
    log-lik moments or final state went NaN/Inf is discarded and rerun
    with a fresh key, the chain-level recovery the reference lacks
    (survey §5, failure detection)."""
    empty = _host(accum.empty_cluster)
    bad_ll = ~np.isfinite(_host(accum.mean.total_ll))
    bad_state = ~np.isfinite(_host(state.loglik_total))
    return empty | bad_ll | bad_state


def _chain_runner(spec: ModelSpec, sched: Schedule, data: Dataset,
                  track_freq: bool, axis_name=None):
    """Returns (init_chain, run_segment): per-chain initialisation and a
    scan over an arbitrary index window [start, start+len) — the unit of
    both the single-shot path and the checkpointed segmented path.

    Both functions take the panel as an explicit trailing argument so the
    jitted programs receive it as a runtime parameter — closing over it
    would embed the genotype tensors as program CONSTANTS, which caps the
    panel size at the compiler's request limit (a 10k x 50k panel is ~1 GB)
    and bloats every compile.  The tetraploid builder precomputes host-side
    combinatoric tables from concrete arrays, so it keeps the closure.

    With ``axis_name`` the returned functions expect to run inside a
    shard_map whose named loci axis is ``axis_name`` and whose panel
    argument is the device-local loci block (parallel/loci_shard.py)."""
    from instruct_jax.mcmc.step import build_step_parts
    check_at = (-1 if (spec.mode == 0 and spec.ploid == 2)
                else sched.nstep_check_empty_cluster)
    tetra = spec.ploid == 4
    tetra_tables = None
    if tetra:
        # Host-side class-table precompute from the concrete panel
        # (shard-0 local view under loci sharding — valid for every
        # shard under the class-uniform layout).  WITHOUT the [C, N, L]
        # candidate planes: the panel reaches the traced programs as a
        # RUNTIME argument (like the diploid path), and the planes are
        # rebuilt in-trace from it (engine.retable_candidates) — keeping
        # concrete ones would embed the panel-sized tensors as program
        # CONSTANTS (gigabytes at biobank sizes).
        from instruct_jax.tetra.engine import build_tables
        src = data
        if axis_name is not None:
            from instruct_jax.parallel import loci_shard as _ls
            src = _ls.local_view(data)
        tetra_tables = build_tables(spec, src, with_candidates=False)

    def init_chain(key: jax.Array, init_rates, rt_data: Dataset,
                   active=None):
        k_init, k_steps = jax.random.split(key)
        state = init_state(k_init, spec, rt_data, init_rates,
                           axis_name=axis_name, active=active,
                           tetra_tables=tetra_tables)
        accum = init_accum(spec, sched, rt_data, track_freq)
        return state, accum, k_steps

    def run_segment(state, accum, k_steps, idxs, rt_data: Dataset):
        from instruct_jax.mcmc.step import build_marg_loglik
        step_core, add_loglik = build_step_parts(spec, rt_data, axis_name,
                                                 tetra_tables)
        add_marg = build_marg_loglik(spec, rt_data, axis_name,
                                     tetra_tables)
        last_idx = idxs[-1]

        def body(carry, step_idx):
            state, accum = carry
            state = step_core(state, jax.random.fold_in(k_steps, step_idx))
            stored = ((step_idx >= sched.burnin)
                      & ((step_idx + 1 - sched.burnin) % sched.thinning == 0))
            # cal_lkh only when the draw is consumed (stored) or reported
            # (segment end).  The predicate depends only on the unbatched
            # step index, so under the chains vmap this stays a real branch
            # rather than select-both.
            state = jax.lax.cond(stored | (step_idx == last_idx),
                                 add_loglik, lambda s: s, state)
            if add_marg is not None:
                # Z-marginalized log-lik for the corrected DIC, refreshed
                # on a subsampled stored-step cadence (held constant in
                # between — the repeated value is an unbiased subsample
                # mean of E[logL_marg]).
                nth = (step_idx + 1 - sched.burnin) // sched.thinning - 1
                due = stored & (nth % sched.dic_every == 0)
                state = jax.lax.cond(due, add_marg, lambda s: s, state)
            stats = extract_stats(spec, state, track_freq)
            empty = up.empty_cluster_flag(stats.q, state.active)
            accum = accum_update(accum, stats, stored, empty, check_at)
            return (state, accum), None

        (state, accum), _ = jax.lax.scan(body, (state, accum), idxs)
        return state, accum

    return init_chain, run_segment


def run_mcmc(
    data: Dataset,
    spec: ModelSpec,
    sched: Schedule,
    key: jax.Array,
    init_rates: Optional[np.ndarray] = None,
    track_freq: bool = False,
    max_retries: int = 10,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100_000,
    progress_every: Optional[int] = None,
    progress_fn=None,
    jsonl_log: Optional[str] = None,
    mesh_mode: str = "auto",
    active_pops: Optional[np.ndarray] = None,
) -> RunResult:
    """Run ``sched.n_chains`` chains and return streaming posterior moments.

    ``init_rates`` optionally gives per-chain initial S/F vectors
    [n_chains, R] (the role of the `-i` initial file, initial.c:38-126);
    otherwise each chain draws U(0,1) starts.

    ``active_pops`` optionally gives a per-chain active-pop mask
    [n_chains, K] (1.0 = slot in use): the padded (chain x K) K-selection
    grid (kselect.py) folds every K value into the chains axis of ONE
    compiled run, each replica Gibbs-sampling only its leading active
    slots (q/z put exactly zero mass on padding; mode 0's per-individual
    z never selects an inactive slot).  Diploid modes 0-5; not combined
    with loci sharding.

    With ``mesh`` (a ("chain","data") `jax.sharding.Mesh`), chains are
    sharded over the "chain" axis and the loci axis over "data".

    ``mesh_mode`` selects how a nontrivial "data" axis is partitioned:

    * "auto" / "shard_map" — explicit SPMD: the panel is split into
      contiguous per-device loci blocks and the step runs inside a
      shard_map with named-axis psums of the per-individual counts and MH
      log-ratio columns (parallel/loci_shard.py).  The fused Pallas
      kernels stay usable (each device runs them on its local block), the
      collective set is auditable, and site-level PRNG streams are
      shard-folded — so trajectories differ from the unsharded run by
      design (statistically equivalent; posterior parity is tested).
      Tetraploid panels shard too, under the class-uniform permuted
      loci layout (parallel/loci_shard.py:stack_loci_tetra).
    * "gspmd" — GSPMD auto-partitioning of the XLA path from input
      shardings (bitwise-identical to the unsharded run, but incompatible
      with the fused Pallas custom calls).
    """
    n_chains = sched.n_chains
    host_data = data   # pre-sharding view, for the end-of-run plug-in pass
    r = spec.n_rates(data.n_indv)
    if init_rates is None:
        none_rates = True
        init_rates = jnp.zeros((n_chains, max(r, 1)), jnp.float32)
    else:
        none_rates = False
        init_rates = jnp.asarray(init_rates, jnp.float32).reshape(n_chains, -1)

    chain_keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(
        jnp.arange(n_chains))

    chain_shardmap = False
    data_shardmap = False
    n_ds = 1
    if mesh is not None:
        from instruct_jax.parallel.mesh import (CHAIN_AXIS, DATA_AXIS,
                                                chain_sharding,
                                                shard_dataset)
        n_cs = mesh.shape.get(CHAIN_AXIS, 1)
        n_ds = mesh.shape.get(DATA_AXIS, 1)
        # Pure chain parallelism (data axis trivial): run the step under an
        # explicit shard_map over "chain" — each device executes whole
        # chains locally, so the fused Pallas kernels work multi-device and
        # there is ZERO communication in the step loop.
        chain_shardmap = (n_ds == 1 and n_cs > 1 and n_chains % n_cs == 0)
        # Loci sharding: explicit shard_map SPMD (default) or GSPMD.
        # Diploid panels shard contiguous loci blocks; tetraploid panels
        # use the class-uniform permuted layout (loci_shard.py).
        if n_ds > 1 and mesh_mode in ("auto", "shard_map"):
            data_shardmap = n_chains % n_cs == 0
            if not data_shardmap and mesh_mode == "shard_map":
                raise ValueError(
                    "mesh_mode='shard_map' requires n_chains divisible "
                    f"by the '{CHAIN_AXIS}' axis")
        if (mesh.devices.size > 1 and not chain_shardmap
                and not data_shardmap):
            # GSPMD fallback: it cannot partition the fused Pallas custom
            # calls, so force the XLA path.
            if spec.use_pallas is True:
                raise ValueError(
                    "use_pallas=True cannot be combined with a sharded "
                    f"'{DATA_AXIS}' mesh axis ({n_ds} shards) under "
                    "mesh_mode='gspmd': GSPMD cannot partition the fused "
                    "Pallas custom calls. Use mesh_mode='auto' (explicit "
                    "shard_map loci sharding, fused kernels stay on), "
                    "use_pallas=None/False (XLA path), or a pure "
                    "chain-parallel mesh.")
            spec = dataclasses.replace(spec, use_pallas=False)
        if not chain_shardmap and not data_shardmap:
            data = shard_dataset(mesh, data)
        # shard_map paths: the panel is an explicit P(DATA)-spec argument
        # (data path) or a replicated closure constant (chain path) —
        # explicit NamedShardings would clash with the Manual mesh context.
        if n_chains % mesh.devices.shape[0] == 0 or chain_shardmap \
                or data_shardmap:
            cs = chain_sharding(mesh)
            # PRNG keys go through their uint32 key data: device_put of an
            # extended-dtype array onto a process-spanning (multi-host)
            # sharding is rejected, plain dtypes are not
            kd = jax.device_put(jax.random.key_data(chain_keys), cs)
            chain_keys = jax.jit(jax.random.wrap_key_data)(kd)
            init_rates = jax.device_put(init_rates, cs)

    active_dev = None
    if active_pops is not None:
        if spec.ploid != 2:
            raise ValueError(
                "active_pops (the padded K-selection grid) supports the "
                "diploid modes 0-5 only; the tetraploid sweep runs per-K")
        if n_ds > 1:
            raise NotImplementedError(
                "active_pops is not supported together with loci sharding; "
                "use a chain-parallel mesh for the K grid")
        active_dev = jnp.asarray(active_pops, jnp.float32).reshape(
            n_chains, spec.n_pops)
        if mesh is not None and (n_chains % mesh.devices.shape[0] == 0
                                 or chain_shardmap):
            from instruct_jax.parallel.mesh import chain_sharding
            active_dev = jax.device_put(active_dev, chain_sharding(mesh))

    if data_shardmap:
        # stack BEFORE building the chain runner: the tetraploid runner
        # builds its class tables from the stacked panel's shard-0 view
        from instruct_jax.parallel import loci_shard as ls
        data = ls.stack_loci(data, n_ds)     # leading shard axis, P(dp)

    init_chain, run_segment = _chain_runner(
        spec, sched, data, track_freq,
        axis_name=(DATA_AXIS if data_shardmap else None))

    def per_chain_init(key, rates_row, rt_data, active_row=None):
        rates0 = None if none_rates else rates_row[:r]
        return init_chain(key, rates0, rt_data, active_row)

    if data_shardmap:
        from instruct_jax.parallel.mesh import get_shard_map
        shard_map = get_shard_map()
        from jax.sharding import PartitionSpec as P
        from instruct_jax.mcmc.accumulators import TrackedStats
        cp, dp = P(CHAIN_AXIS), P(DATA_AXIS)

        loci_sharded_4 = P(CHAIN_AXIS, None, DATA_AXIS, None)
        has_zc = spec.ploid == 2 and spec.mode in (1, 2, 3, 4, 5)
        allo = spec.ploid == 4 and not spec.autopoly
        state_spec = McmcState(
            freq=loci_sharded_4,
            z=P(CHAIN_AXIS, None, DATA_AXIS),
            zz=cp, q=cp, alpha=cp, rates=cp, ais_state=cp, gen=cp,
            loglik_indv=cp, loglik_total=cp, dpm_values=cp, dpm_counts=cp,
            dpm_assign=cp, prior_mu=cp, prior_sigma2=cp,
            freq2=(loci_sharded_4 if spec.ploid == 4 else None),
            geno=(P(CHAIN_AXIS, None, DATA_AXIS) if spec.ploid == 4
                  else None),
            zcounts=(loci_sharded_4 if has_zc else None),
            loglik_marg=cp)
        stats_spec = TrackedStats(
            total_ll=cp, indv_ll=cp, q=cp, rates=cp, gen=cp,
            freq=(loci_sharded_4 if track_freq else cp),
            ll_marg=cp,
            freq2=(loci_sharded_4 if (track_freq and allo) else cp))
        accum_spec = ChainAccum(count=cp, mean=stats_spec,
                                mean_sq=stats_spec, convg_ld=cp,
                                empty_cluster=cp, lme_indv=cp,
                                m2_ll_marg=cp)
        # every present panel leaf is stacked on the leading shard axis
        data_spec = jax.tree.map(lambda _: dp, data)

        def _init_body(kdata, rates_rows, stacked):
            rt = ls.local_view(stacked)

            def one(kd, rrow):
                st, ac, ks = per_chain_init(jax.random.wrap_key_data(kd),
                                            rrow, rt)
                return st, ac, jax.random.key_data(ks)

            return jax.vmap(one)(kdata, rates_rows)

        _init_sm = shard_map(_init_body, mesh=mesh,
                             in_specs=(cp, cp, data_spec),
                             out_specs=(state_spec, accum_spec, cp))

        def _vinit(keys, rates_rows, stacked):
            st, ac, kd = _init_sm(jax.random.key_data(keys), rates_rows,
                                  stacked)
            return st, ac, jax.random.wrap_key_data(kd)

        vinit = jax.jit(_vinit)

        def _seg_body(states, accums, kdata, idxs, stacked):
            rt = ls.local_view(stacked)
            kstep = jax.random.wrap_key_data(kdata)
            return jax.vmap(run_segment, in_axes=(0, 0, 0, None, None))(
                states, accums, kstep, idxs, rt)

        _seg_sm = shard_map(_seg_body, mesh=mesh,
                            in_specs=(state_spec, accum_spec, cp, P(),
                                      data_spec),
                            out_specs=(state_spec, accum_spec))

        def _vseg(states, accums, kstep, idxs, stacked):
            return _seg_sm(states, accums, jax.random.key_data(kstep),
                           idxs, stacked)

        vseg = jax.jit(_vseg)
    elif active_dev is None:
        vinit = jax.jit(jax.vmap(per_chain_init, in_axes=(0, 0, None)))
    else:
        _vinit_act = jax.jit(jax.vmap(per_chain_init,
                                      in_axes=(0, 0, None, 0)))

        def vinit(keys, rates_rows, d):
            return _vinit_act(keys, rates_rows, d, active_dev)
    if chain_shardmap:
        from instruct_jax.parallel.mesh import get_shard_map
        shard_map = get_shard_map()
        from jax.sharding import PartitionSpec as P
        cp = P(CHAIN_AXIS)

        def _local_seg(states, accums, kdata, idxs, rt_data):
            kstep = jax.random.wrap_key_data(kdata)
            return jax.vmap(run_segment, in_axes=(0, 0, 0, None, None))(
                states, accums, kstep, idxs, rt_data)

        _shmapped = shard_map(_local_seg, mesh=mesh,
                              in_specs=(cp, cp, cp, P(), P()),
                              out_specs=(cp, cp))

        def _vseg(states, accums, kstep, idxs, rt_data):
            return _shmapped(states, accums, jax.random.key_data(kstep),
                             idxs, rt_data)

        vseg = jax.jit(_vseg)
    elif not data_shardmap:
        vseg = jax.jit(jax.vmap(run_segment,
                                in_axes=(0, 0, 0, None, None)))

    segmented = checkpoint_dir is not None or progress_every is not None

    def full_run(keys, ckpt_dir=checkpoint_dir):
        states, accums, kstep = vinit(keys, init_rates, data)
        if not segmented:
            idxs = jnp.arange(sched.n_iter, dtype=jnp.int32)
            states, accums = vseg(states, accums, kstep, idxs, data)
            return states, accums
        return _segmented(states, accums, kstep, ckpt_dir)

    def _report(start, states, accums):
        """print_info parity (mcmc.c:1267-1316) + JSONL metrics.

        The reference runs chains sequentially and each prints its own
        `Step=..` header plus a line of every current S/F value (s_i= for
        modes 2/3 and the tetraploid engine, f_i= for 4/5, with the
        adaptive-independence st_i= states when back_refl==0).  Here the
        chains advance in lockstep, so each report emits one such block
        PER CHAIN.  Per-individual modes at scale cap the stdout line at
        512 values (a 10k-individual x 8-chain run would otherwise print
        ~1 MB per report) and summarize the rest; the JSONL log always
        carries the full rates matrix."""
        ll = _host(states.loglik_total)
        rates = _host(states.rates)
        if progress_fn is not None:
            progress_fn(start, states, accums)
        else:
            prefix = ("f" if (spec.ploid == 2 and spec.mode in (4, 5))
                      else "s")
            show_st = (spec.back_refl == 0
                       and (spec.rates_are_per_pop or spec.ploid == 4))
            st = _host(states.ais_state) if show_st else None
            lines = []
            for ci in range(ll.shape[0]):
                lines.append(f"\nStep={start}\tchain={ci}"
                             f"\tlog_likelihood={ll[ci]:f}")
                if rates.size:
                    shown = min(rates.shape[-1], 512)
                    parts = []
                    for i, v in enumerate(rates[ci][:shown]):
                        parts.append(f"{prefix}_{i}={v:f}")
                        if st is not None:
                            parts.append(f"st_{i}={int(st[ci, i])}")
                    if shown < rates.shape[-1]:
                        row = rates[ci]
                        parts.append(
                            f"... [{rates.shape[-1] - shown} more; "
                            f"min={row.min():f} mean={row.mean():f} "
                            f"max={row.max():f}; full values in the "
                            "JSONL log]")
                    lines.append(" ".join(parts))
            print("\n".join(lines), flush=True)
        if jsonl_log:
            import json
            with open(jsonl_log, "a") as fh:
                fh.write(json.dumps({
                    "step": int(start),
                    "loglik": ll.tolist(),
                    "rates": rates.tolist() if rates.size else None,
                    "stored": int(np.asarray(accums.count)[0]),
                }) + "\n")

    def _segmented(states, accums, kstep, ckpt_dir):
        from instruct_jax import checkpoint as ckpt
        # typed PRNG keys are stored as their raw uint32 key data
        kdata = jax.random.key_data(kstep)
        start = 0
        if ckpt_dir is not None:
            latest = ckpt.latest_step(ckpt_dir)
            if latest is not None and 0 < latest <= sched.n_iter:
                states, accums, kdata = ckpt.restore_checkpoint(
                    ckpt_dir, latest, (states, accums, kdata))
                start = latest
                if (states.zcounts is not None
                        and getattr(states, "z", None) is not None
                        and states.z.size):
                    # zcounts is DERIVED state (the fused path's carried
                    # P-update counts): recompute from the restored z
                    # rather than trusting the saved value, so checkpoints
                    # transfer across the fused/XLA paths (ADVICE r1).
                    if data_shardmap:
                        from instruct_jax.parallel.mesh import (
                            get_shard_map)
                        _sm = get_shard_map()

                        def _rc_body(z, zz, stacked):
                            rt = ls.local_view(stacked)
                            return jax.vmap(
                                lambda zi, zzi: up.allele_pop_counts(
                                    spec, rt, zi, zzi))(z, zz)

                        recount = jax.jit(_sm(
                            _rc_body, mesh=mesh,
                            in_specs=(state_spec.z, cp, data_spec),
                            out_specs=state_spec.zcounts))
                        states = states._replace(
                            zcounts=recount(states.z, states.zz, data))
                    else:
                        recount = jax.jit(jax.vmap(
                            lambda z, zz: up.allele_pop_counts(
                                spec, data, z, zz), in_axes=(0, 0)))
                        states = states._replace(
                            zcounts=recount(states.z, states.zz))
        kstep = jax.random.wrap_key_data(jnp.asarray(kdata))
        seg_len = min(x for x in (checkpoint_every, progress_every,
                                  sched.n_iter) if x is not None)
        while start < sched.n_iter:
            seg = min(seg_len, sched.n_iter - start)
            idxs = jnp.arange(start, start + seg, dtype=jnp.int32)
            states, accums = vseg(states, accums, kstep, idxs, data)
            start += seg
            jax.block_until_ready(accums.count)
            if ckpt_dir is not None:
                ckpt.save_checkpoint(ckpt_dir, start,
                                     (states, accums, kdata))
            if progress_every is not None or jsonl_log:
                _report(start, states, accums)
        return states, accums

    state, accum = full_run(chain_keys)

    retries = 0
    flags = unhealthy_flags(state, accum)
    while flags.any() and retries < max_retries:
        retries += 1
        if checkpoint_dir is not None:
            # retries of a checkpointed run get their own checkpoint
            # namespace: the main run has already saved its final step, so
            # resuming from it would skip the rerun entirely (VERDICT r4
            # weak #3 — unhealthy chains in production runs were silently
            # kept).  A preempted retry resumes from its own namespace.
            print(f"[instruct_jax] retrying {int(flags.sum())} unhealthy "
                  f"chain(s) (attempt {retries}/{max_retries})", flush=True)
        fresh = jax.vmap(
            lambda c: jax.random.fold_in(
                jax.random.fold_in(key, 10_000 + retries), c)
        )(jnp.arange(n_chains))
        # select per-chain through the raw uint32 key data: a jnp.where
        # on typed [C] key arrays broadcasts the [C, 1] condition against
        # the key axis and silently yields [C, C] keys
        kd = jnp.where(jnp.asarray(flags)[:, None],
                       jax.random.key_data(fresh),
                       jax.random.key_data(chain_keys))
        chain_keys = jax.random.wrap_key_data(kd)
        retry_dir = (None if checkpoint_dir is None else
                     os.path.join(checkpoint_dir, f"retry-{retries}"))
        state, accum = full_run(chain_keys, retry_dir)
        flags = unhealthy_flags(state, accum)
    if flags.any():
        print(f"[instruct_jax] WARNING: {int(flags.sum())} chain(s) still "
              f"unhealthy after {retries} retries (empty cluster or "
              "non-finite log-likelihood); results include them",
              flush=True)

    if jax.process_count() > 1:
        # multi-host: pull the (small) summaries to every host so report
        # writing, DIC/WAIC and downstream numpy consumers work unchanged
        state = jax.tree.map(_host, state)
        accum = jax.tree.map(_host, accum)
    plugin_ll = None
    if track_freq and spec.ploid == 2:
        plugin_ll = _plugin_loglik(spec, host_data, accum, active_pops)
    elif track_freq and spec.ploid == 4 and not data_shardmap:
        # loci-sharded tetra leaves z/geno/P in the permuted blocked
        # layout; the DIC plug-in is skipped (WAIC, computed in-run on
        # the sharded state, remains the model-choice statistic)
        plugin_ll = _plugin_tetra_loglik(spec, host_data, accum, state)
    return RunResult(accum=accum, final_state=state, n_retries=retries,
                     plugin_ll=plugin_ll)


def _plugin_loglik(spec: ModelSpec, data: Dataset, accum: ChainAccum,
                   active_pops=None) -> np.ndarray:
    """Per-chain Z-marginalized log-lik at the posterior means — the
    D(theta_bar) pass of the corrected DIC (one extra device pass over the
    stored moments at run end; means of Dirichlet draws are simplex-valid
    by linearity, and genofreq's closed form accepts the real-valued
    posterior-mean generations)."""
    import jax.numpy as jnp
    from instruct_jax.model import likelihood as lk

    mean = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), accum.mean)

    def one_chain(m, act):
        if spec.mode == 0:
            mat = lk.loglik_matrix_nopop_admix(data, m.freq)
            if act is not None:
                # padded K grid: uniform mixture over active slots only
                mat = jnp.where(act[None, :] > 0, mat, -jnp.inf)
                log_k = jnp.log(jnp.maximum(act.sum(), 1.0))
            else:
                log_k = jnp.log(float(spec.n_pops))
            return (jax.nn.logsumexp(mat, axis=1) - log_k).sum()
        # modes 1-5: inactive padded slots carry exactly zero q mass, so
        # the marginal is already active-correct without masking
        gen = m.gen if spec.has_selfing else None
        rates = m.rates if m.rates.size else None
        return lk.marginal_indv_loglik(spec, data, m.freq, m.q, gen,
                                       rates).sum()

    if active_pops is None:
        fn = jax.jit(jax.vmap(lambda m: one_chain(m, None)))
        return np.asarray(fn(mean))
    act = jnp.asarray(np.asarray(active_pops), jnp.float32)
    return np.asarray(jax.jit(jax.vmap(one_chain))(mean, act))


def _plugin_tetra_loglik(spec: ModelSpec, data: Dataset, accum: ChainAccum,
                         final_state: McmcState) -> np.ndarray:
    """Tetraploid plug-in deviance D(theta_bar) under the (z, geno)-
    conditional focus (see step.build_marg_loglik): one _site_loglik pass
    at the posterior means of (P[, P2], S), conditional on the FINAL
    draw's latent (z, geno) — the discrete ordering latents have no
    posterior mean, so the plug-in conditions on one posterior draw of
    them.  This feeds the corrected DIC's pD column; K-selection itself
    ranks on WAIC (kselect.py), which needs no plug-in."""
    from instruct_jax.tetra.engine import (_site_loglik, build_tables,
                                           log_hwe_table,
                                           selfing_equilibrium)
    tables = build_tables(spec, data, with_candidates=False)
    mean = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), accum.mean)

    def one_chain(m, z, geno):
        freq = m.freq
        freq2 = m.freq2 if m.freq2.size else freq
        log_hwe = log_hwe_table(tables, spec, freq, freq2)
        table = selfing_equilibrium(tables, log_hwe, m.rates)
        site = _site_loglik(tables, spec, data, freq, freq2, z, geno,
                            table)
        return site.sum()

    z = jnp.asarray(np.asarray(final_state.z))
    geno = jnp.asarray(np.asarray(final_state.geno))
    return np.asarray(jax.jit(jax.vmap(one_chain))(mean, z, geno))
