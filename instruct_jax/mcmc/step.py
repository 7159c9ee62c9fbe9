"""Per-mode composition of update kernels into one fused MCMC step.

One call = one full sweep of the reference's step loop for the selected mode
(the bodies of mcmc_POP_no_admixture .. mcmc_INDV_inbreedcoff,
mcmc.c:90-468).  The returned function is pure `(state, key) -> state` and is
designed to be jitted once and driven by `lax.scan`.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from instruct_jax.config import ModelSpec, PriorFamily
from instruct_jax.data.dataset import Dataset
from instruct_jax.mcmc import updates as up
from instruct_jax.mcmc.state import McmcState
from instruct_jax.model import likelihood as lk

# f32 products feeding MH ratios / log-likelihoods: never TF32
_HI = jax.lax.Precision.HIGHEST


def _cal_lkh(spec: ModelSpec, data: Dataset, state: McmcState,
             axis_name=None) -> McmcState:
    """cal_lkh (mcmc.c:1916-1942): per-individual and total log-lik.
    Per-individual sums over loci are psummed under loci sharding."""
    if spec.mode == 0 and spec.ploid == 2:
        ll_matrix = lk.loglik_matrix_nopop_admix(data, state.freq)
        indv = jnp.take_along_axis(ll_matrix, state.zz[:, None], axis=1)[:, 0]
    else:
        indv = lk.per_indv_loglik(spec, data, state.freq, state.z, state.q,
                                  state.gen if spec.has_selfing else None,
                                  state.rates if state.rates.size else None)
    indv = up._psum(indv, axis_name)
    return state._replace(loglik_indv=indv, loglik_total=indv.sum())


def _s_subsweeps_pop(spec: ModelSpec, state: McmcState, ks) -> McmcState:
    """spec.s_subsweeps inner MH sweeps of the mode-2 S update — the S
    conditional given (Q, G) is O(N*K), so extra sweeps cost ~nothing next
    to the site kernels while collapsing the S random-walk autocorrelation
    (the reference does exactly one sweep per step, mcmc.c:209)."""
    for j in range(max(1, spec.s_subsweeps)):
        rates, ais = up.update_s_pop(jax.random.fold_in(ks, j), spec,
                                     state.q, state.gen, state.rates,
                                     state.ais_state)
        state = state._replace(rates=rates, ais_state=ais)
    return state


def _s_subsweeps_ind(spec: ModelSpec, state: McmcState, ks,
                     normal: bool) -> McmcState:
    """Mode-3 equivalent of :func:`_s_subsweeps_pop` (per-individual S,
    uniform or normal prior); the conjugate hyper update runs once after
    the sweeps."""
    pm = state.prior_mu if normal else None
    ps2 = state.prior_sigma2 if normal else None
    for j in range(max(1, spec.s_subsweeps)):
        rates = up.update_s_ind(jax.random.fold_in(ks, j), spec, state.gen,
                                state.rates, pm, ps2)
        state = state._replace(rates=rates)
    if normal:
        mu, s2 = up.update_normal_hyper(
            jax.random.fold_in(ks, 777), state.rates, spec.priors)
        state = state._replace(prior_mu=mu, prior_sigma2=s2)
    return state


def _marg_s_and_gen(spec: ModelSpec, state: McmcState, gtable, ks, kg,
                    dpm_update, normal: bool) -> McmcState:
    """Shared ``marginalize_g`` tail for modes 2/3 (both step paths): the
    Rao-Blackwellized S update on the G-marginal target, then the exact
    categorical G draw — all O(N * gen_cap) given the curve."""
    from instruct_jax.mcmc import marg_g as mg
    if spec.mode == 2:
        for j in range(max(1, spec.s_subsweeps)):
            rates, ais = mg.update_s_pop_marginal(
                jax.random.fold_in(ks, j), spec, state.q, gtable,
                state.rates, state.ais_state)
            state = state._replace(rates=rates, ais_state=ais)
        sbar = jnp.dot(state.q, state.rates, precision=_HI)
    elif dpm_update is not None:
        state = dpm_update(ks, state)
        sbar = state.rates
    else:
        pm = state.prior_mu if normal else None
        ps2 = state.prior_sigma2 if normal else None
        for j in range(max(1, spec.s_subsweeps)):
            rates = mg.update_s_ind_marginal(
                jax.random.fold_in(ks, j), spec, gtable, state.rates,
                pm, ps2)
            state = state._replace(rates=rates)
        if normal:
            mu, s2 = up.update_normal_hyper(
                jax.random.fold_in(ks, 777), state.rates, spec.priors)
            state = state._replace(prior_mu=mu, prior_sigma2=s2)
        sbar = state.rates
    gen = mg.sample_gen_marginal(kg, gtable, sbar, spec.gen_cap)
    return state._replace(gen=gen)


def _use_fused(spec: ModelSpec, data: Dataset) -> bool:
    """Fused Pallas step path (kernels/fused_step.py): modes 1-5, diploid,
    on a platform with a kernel route (kernels.pallas_route — the Triton
    route on GPU).  `use_pallas=None` takes the route where there is one;
    False forces the XLA path; True raises where there is no route.

    Mode-5 DPM composes with the fused kernels too: its [N, M] grid curve
    (dpm.f_loglik_grid) is a cheap stack of masked matmuls evaluated
    before the site pass, and the CRP/stick sweep then fixes F so the
    fused zq_f_pass runs with an identity F-proposal pair."""
    from instruct_jax.kernels import pallas_route
    from instruct_jax.kernels.fused_step import MAX_POP_ALLELE_CELLS
    if pallas_route(spec.use_pallas) is None:
        return False
    return (spec.ploid == 2 and spec.mode in (1, 2, 3, 4, 5)
            and spec.n_pops * data.max_alleles <= MAX_POP_ALLELE_CELLS)


def _build_fused_parts(spec: ModelSpec, data: Dataset, axis_name=None,
                       s_tail_kernel: bool = True):
    """Fused-path (step_core, add_loglik): the sweep without the final
    cal_lkh pass, plus the pass as a separate function so the driver can
    run it only on stored/reported steps (the log-lik is a pure observable
    — no update conditions on it — so skipping it off-sample is exact).

    Sweep-order note: the fused site pass evaluates the G/F MH log-ratio
    at the z it has just drawn (still in registers), i.e. the scan order
    is "Z, then G|z" / "Z, then F|z" — a permutation of the reference's
    G/F-then-Z order (mcmc.c:208-215, 263-269) with the same invariant
    distribution, chosen because it drops the carried-z input planes from
    the hot kernel.  The XLA path below keeps the reference order.

    ``s_tail_kernel`` False keeps the mode-2 S tail on XLA (the site pass
    stays fused) — the switch the on-card timing uses to weigh the two
    kernels separately.

    Under loci sharding (``axis_name`` set, parallel/loci_shard.py) the
    kernels run on the device-local panel; site-level PRNG seeds are
    shard-folded, replicated draws (Q, alpha, S/F/G proposals + accepts)
    keep the unfolded key, and the per-individual count/log-ratio columns
    are psummed — the same collective set as the XLA path."""
    from instruct_jax.kernels import fused_step as fs
    from instruct_jax.kernels.s_pop_pallas import s_pop_tail

    structure = spec.type_freq == 1
    marg = spec.marginalize_g and spec.mode in (2, 3)
    s_tail_fused = s_tail_kernel and _s_tail_applies(spec)
    normal = (spec.priors.family == PriorFamily.NORMAL
              and spec.mode in (3, 5))
    dpm = spec.priors.family == PriorFamily.DPM and spec.mode in (3, 5)
    if dpm:
        from instruct_jax.mcmc.dpm import build_dpm_update
        dpm_update = build_dpm_update(spec, data, axis_name)
    if marg:
        from instruct_jax.mcmc import marg_g as mg

    def draw_q(kq, qqnum, alpha, active=None):
        """Q | Z ~ Dirichlet(counts + alpha); qqnum must be the GLOBAL
        (psummed) counts and the unfolded key keeps the draw replicated
        across loci shards.  With ``active`` (padded K grid) the inactive
        slots are masked out of the Dirichlet."""
        return up.dirichlet_from_counts(
            kq, qqnum + alpha,
            None if active is None else (active > 0)[None, :])

    def step(state: McmcState, key: jax.Array) -> McmcState:
        kp, ks, kg, kz, ka, kq, kacc = jax.random.split(key, 7)
        kp = up.shard_key(kp, axis_name)
        kz = up.shard_key(kz, axis_name)

        # P | Z from the counts carried out of the previous zq pass —
        # no pass over the site tensors needed (update_P, mcmc.c:799-861)
        freq = up.dirichlet_from_counts(kp, state.zcounts + 1.0,
                                        data.allele_valid[None])
        state = state._replace(freq=freq)

        if spec.mode in (4, 5):
            return _f_tail(state, ks, kz, ka, kq, kacc)

        if marg:
            return _marg_tail(state, ks, kg, kz, ka, kq)

        if spec.mode == 2:
            if not s_tail_fused:
                state = _s_subsweeps_pop(spec, state, ks)
        elif spec.mode == 3:
            if dpm:
                # CRP/stick sweep conditions only on gen (replicated), so
                # it composes with the fused site kernels unchanged
                state = dpm_update(ks, state)
            else:
                state = _s_subsweeps_ind(spec, state, ks, normal)

        seed = fs.seed_words(kz)
        if spec.mode == 1:
            # sampling-only pass; cal_lkh is deferred to stored steps
            z, qqnum, zcounts = fs.zq_sample_pass(
                seed, state.q, freq, data.geno, data.site_valid,
                bits2=data.bits2)
            q_new = draw_q(kq, up._psum(qqnum, axis_name), state.alpha,
                           state.active)
            alpha = up.update_alpha(ka, spec, q_new, state.alpha,
                                    state.active)
            return state._replace(z=z, q=q_new, alpha=alpha,
                                  zcounts=zcounts)

        # modes 2/3: G proposal, fused zq+gendiff pass, G accept
        if spec.mode == 2 and s_tail_fused:
            # one Pallas pass replaces the J*K S-subsweep micro-kernels +
            # the G-proposal / wg / accept-uniform draws
            # (kernels/s_pop_pallas.py); the unfolded key keeps every
            # output replicated across loci shards
            rates_new, gen_prop, wg_pair, logu = s_pop_tail(
                fs.seed_words(ks), state.q, state.gen, state.rates,
                subsweeps=spec.s_subsweeps, delta0=spec.mh_step_s,
                gen_cap=spec.gen_cap)
            state = state._replace(rates=rates_new)
        else:
            sbar = (jnp.dot(state.q, state.rates, precision=_HI)
                    if spec.mode == 2
                    else state.rates)
            gen_prop = up.sample_geometric(kg, sbar, spec.gen_cap)
            wg_pair = jnp.exp2(1.0 - jnp.stack(
                [state.gen, gen_prop], axis=1).astype(jnp.float32))
            u = jax.random.uniform(kacc, state.gen.shape, minval=1e-30)
            logu = jnp.log(u)
        z, qqnum, ll_diff, zcounts = fs.zq_gendiff_pass(
            seed, state.q, freq, data.geno, data.site_valid, data.hom,
            state.z, wg_pair, structure=structure, bits2=data.bits2)
        qqnum = up._psum(qqnum, axis_name)
        ll_diff = up._psum(ll_diff, axis_name)
        gen = jnp.where(logu < ll_diff, gen_prop, state.gen)

        q_new = draw_q(kq, qqnum, state.alpha, state.active)
        alpha = up.update_alpha(ka, spec, q_new, state.alpha, state.active)
        return state._replace(z=z, q=q_new, alpha=alpha, gen=gen,
                              zcounts=zcounts)

    def _marg_tail(state, ks, kg, kz, ka, kq):
        """Modes 2/3 with ``marginalize_g``: the per-individual curve over
        g (mcmc/marg_g.py, masked matmuls) feeds a Rao-Blackwellized S
        update and an exact categorical G draw; the Z pass then needs no
        G inputs, so it runs the same fused sampling-only kernel as
        mode 1."""
        gtable = mg.selfing_gtable(data, state.freq, state.z, spec.gen_cap,
                                   axis_name)
        state = _marg_s_and_gen(spec, state, gtable, ks, kg,
                                dpm_update if dpm else None, normal)
        z, qqnum, zcounts = fs.zq_sample_pass(
            fs.seed_words(kz), state.q, state.freq, data.geno,
            data.site_valid, bits2=data.bits2)
        q_new = draw_q(kq, up._psum(qqnum, axis_name), state.alpha,
                       state.active)
        alpha = up.update_alpha(ka, spec, q_new, state.alpha, state.active)
        return state._replace(z=z, q=q_new, alpha=alpha,
                              zcounts=zcounts)

    def _f_tail(state, ks, kz, ka, kq, kacc):
        """Modes 4/5: fused F-MH + Z-Gibbs pass, then Q and alpha
        (mcmc_POP_inbreedcoff / mcmc_INDV_inbreedcoff, mcmc.c:242-293,
        386-468).  Mode-5 DPM: the CRP/stick sweep (on the fresh P and the
        carried Z, same order as the XLA path) sets F directly, and the
        site pass runs with an identity proposal pair — the MH accept is
        then a no-op and Z/Q/counts come out of the same fused kernel."""
        kprop = jax.random.fold_in(ks, 0)
        if dpm:
            state = dpm_update(ks, state)
            prop = state.rates
            prop_states = state.ais_state
            log_hast = jnp.zeros_like(state.rates)
        elif spec.mode == 4 and spec.back_refl != 1:
            prop, prop_states, log_hast = \
                up.propose_adaptive_independence(kprop, state.rates,
                                                 state.ais_state)
        else:
            prop = up.propose_back_reflection(kprop, state.rates,
                                              spec.mh_step_s)
            prop_states = state.ais_state
            log_hast = jnp.zeros_like(state.rates)
        f_pair = jnp.stack([state.rates, prop], axis=1)      # [R, 2]
        seed = fs.seed_words(kz)
        z, qqnum, ll, zcounts = fs.zq_f_pass(
            seed, state.q, state.freq, data.geno, data.site_valid,
            data.hom, state.z, f_pair, pop=(spec.mode == 4),
            bits2=data.bits2)
        qqnum = up._psum(qqnum, axis_name)
        ll = up._psum(ll, axis_name)
        if spec.mode == 4:
            log_ratio = ll.sum(axis=0) + log_hast            # [K]
        else:
            log_ratio = ll                                   # [N] diff col
            if normal:
                def pri(f):
                    return (-0.5 * (f - state.prior_mu) ** 2
                            / state.prior_sigma2)
                log_ratio = log_ratio + pri(prop) - pri(state.rates)
        u = jax.random.uniform(kacc, state.rates.shape, minval=1e-30)
        accept = jnp.log(u) < log_ratio
        rates = jnp.where(accept, prop, state.rates)
        ais = jnp.where(accept, prop_states, state.ais_state)
        state = state._replace(rates=rates, ais_state=ais)
        if spec.mode == 5 and normal:
            mu, s2 = up.update_normal_hyper(
                jax.random.fold_in(ks, 1), rates, spec.priors)
            state = state._replace(prior_mu=mu, prior_sigma2=s2)
        q_new = draw_q(kq, qqnum, state.alpha, state.active)
        alpha = up.update_alpha(ka, spec, q_new, state.alpha, state.active)
        return state._replace(z=z, q=q_new, alpha=alpha,
                              zcounts=zcounts)

    def add_loglik(state: McmcState) -> McmcState:
        if spec.mode == 1:
            ll_indv = fs.panel_loglik_mode1_pass(
                state.freq, state.q, data.geno, data.site_valid, state.z,
                bits2=data.bits2)
        elif spec.mode in (4, 5):
            f = state.rates[:, None]
            ll_indv = fs.panel_loglik_f_pass(
                state.freq, data.geno, data.site_valid, data.hom, state.z,
                f, pop=(spec.mode == 4), bits2=data.bits2)
        else:
            wg = jnp.exp2(1.0 - state.gen.astype(jnp.float32))[:, None]
            ll_indv = fs.panel_loglik_pass(
                state.freq, state.q, data.geno, data.site_valid, data.hom,
                state.z, wg, structure=structure, bits2=data.bits2)
        ll_indv = up._psum(ll_indv, axis_name)
        return state._replace(loglik_indv=ll_indv,
                              loglik_total=ll_indv.sum())

    return step, add_loglik


def build_step_parts(spec: ModelSpec, data: Dataset, axis_name=None,
                     tetra_tables=None):
    """Return `(step_core, add_loglik)` for the given mode.

    ``axis_name`` names the loci-shard mesh axis when the step runs inside
    a shard_map over a data-parallel mesh (parallel/loci_shard.py): the
    per-individual reductions become psums and site-level PRNG streams are
    shard-folded; ``None`` (default) is the unsharded program.

    ``step_core(state, key)`` runs the full parameter sweep;
    ``add_loglik(state)`` fills `loglik_indv`/`loglik_total` (cal_lkh,
    mcmc.c:1916-1942).  The split lets the chain driver evaluate the
    log-likelihood only on stored/reported steps — it is an observable,
    not an input to any update, so this is exact, and at the default
    thinning of 10 it removes ~90% of the cal_lkh passes.

    Update order per mode matches the reference loops exactly:
      mode 0: P, Z, lkh                       (mcmc.c:111-115)
      mode 1: P, ZQ, alpha, lkh               (mcmc.c:150-155)
      mode 2: P, S_pop, G, ZQ, alpha, lkh     (mcmc.c:208-215)
      mode 3: P, S_ind|DPM, G, ZQ, alpha, lkh (mcmc.c:334-348)
      mode 4: P, F_pop, ZQ, alpha, lkh        (mcmc.c:263-269)
      mode 5: P, F_ind|DPM, ZQ, alpha, lkh    (mcmc.c:420-434)

    Where the platform has a kernel route (GPU) the diploid modes 1-5
    compile to the fused Pallas path (see :func:`_build_fused_parts`).
    """
    if spec.marginalize_g and (spec.mode not in (2, 3) or spec.ploid != 2):
        raise ValueError(
            "marginalize_g applies to the diploid selfing modes 2/3 "
            "(the only modes with generation latents)")
    if spec.ploid == 4:
        from instruct_jax.tetra.engine import build_tetra_step
        if axis_name is not None and tetra_tables is None:
            raise ValueError(
                "the loci-sharded tetraploid step needs prebuilt class "
                "tables (build_tables on a concrete shard-local view "
                "under the class-uniform layout — the chain driver "
                "passes them; see tetra/engine.build_tetra_step)")
        return build_tetra_step(spec, data, axis_name, tetra_tables)
    if spec.mode not in (0, 1, 2, 3, 4, 5):
        raise ValueError(f"unknown mode {spec.mode}")
    if spec.marginalize_g:
        if spec.type_freq != 1:
            raise ValueError(
                "marginalize_g requires the structure-way genotype "
                "formulation (type_freq=1): the expectation way's "
                "Q-mixture probability does not factorize through the "
                "(pop, allele) one-hot the curve tables need")
    if _use_fused(spec, data):
        return _build_fused_parts(spec, data, axis_name)
    from instruct_jax.kernels import pallas_route
    return _build_xla_parts(
        spec, data, axis_name,
        s_tail_kernel=(spec.ploid == 2
                       and pallas_route(spec.use_pallas) is not None))


def _s_tail_applies(spec: ModelSpec) -> bool:
    """The fused mode-2 S tail (kernels/s_pop_pallas.py) needs the
    back-reflection proposal (the adaptive-independence state machine
    stays on XLA) and at most MAX_POPS pops; the G-marginalized sweep has
    its own S update."""
    from instruct_jax.kernels.s_pop_pallas import MAX_POPS
    return (spec.mode == 2 and spec.back_refl == 1
            and spec.n_pops <= MAX_POPS and not spec.marginalize_g)


def _build_xla_parts(spec: ModelSpec, data: Dataset, axis_name=None,
                     s_tail_kernel: bool = False):
    """XLA-path (step_core, add_loglik), in the reference's update order.
    ``s_tail_kernel`` runs the mode-2 S update and the G proposal/accept
    draws through the fused S-tail kernel; the site updates stay on XLA."""
    s_tail = s_tail_kernel and _s_tail_applies(spec)
    dpm = (spec.priors.family == PriorFamily.DPM and spec.mode in (3, 5))
    normal = (spec.priors.family == PriorFamily.NORMAL
              and spec.mode in (3, 5))
    marg = spec.marginalize_g and spec.mode in (2, 3) and spec.ploid == 2
    if dpm:
        from instruct_jax.mcmc.dpm import build_dpm_update
        dpm_update = build_dpm_update(spec, data, axis_name)
    if marg:
        from instruct_jax.mcmc import marg_g as mg

    def step(state: McmcState, key: jax.Array) -> McmcState:
        kp, ks, kg, kz, ka = jax.random.split(key, 5)

        freq = up.update_freq(kp, spec, data, state.z, state.zz,
                              axis_name=axis_name)
        state = state._replace(freq=freq)

        if spec.mode == 0:
            zz = up.update_z_noadmix(kz, data, freq, axis_name=axis_name,
                                     active=state.active)
            return state._replace(zz=zz)

        if marg:
            gtable = mg.selfing_gtable(data, freq, state.z, spec.gen_cap,
                                       axis_name)
            state = _marg_s_and_gen(spec, state, gtable, ks, kg,
                                    dpm_update if dpm else None, normal)
        elif spec.mode == 2 and s_tail:
            from instruct_jax.kernels.fused_step import seed_words
            from instruct_jax.kernels.s_pop_pallas import s_pop_tail
            rates, gen_prop, _, logu = s_pop_tail(
                seed_words(ks), state.q, state.gen, state.rates,
                subsweeps=spec.s_subsweeps, delta0=spec.mh_step_s,
                gen_cap=spec.gen_cap)
            state = state._replace(rates=rates)
        elif spec.mode == 2:
            state = _s_subsweeps_pop(spec, state, ks)
        elif spec.mode == 3:
            if dpm:
                state = dpm_update(ks, state)
            else:
                state = _s_subsweeps_ind(spec, state, ks, normal)
        elif spec.mode == 4:
            rates, ais = up.update_f_pop(ks, spec, data, freq, state.z,
                                         state.rates, state.ais_state,
                                         axis_name=axis_name)
            state = state._replace(rates=rates, ais_state=ais)
        elif spec.mode == 5:
            if dpm:
                state = dpm_update(ks, state)
            else:
                pm = state.prior_mu if normal else None
                ps2 = state.prior_sigma2 if normal else None
                rates = up.update_f_ind(ks, spec, data, freq, state.z,
                                        state.rates, pm, ps2,
                                        axis_name=axis_name)
                state = state._replace(rates=rates)
                if normal:
                    mu, s2 = up.update_normal_hyper(
                        jax.random.fold_in(ks, 1), rates, spec.priors)
                    state = state._replace(prior_mu=mu, prior_sigma2=s2)

        if spec.has_selfing and not marg:
            gen = up.update_gen(kg, spec, data, freq, state.z, state.q,
                                state.rates, state.gen, axis_name=axis_name,
                                prop=gen_prop if s_tail else None,
                                logu=logu if s_tail else None)
            state = state._replace(gen=gen)

        z, q, _ = up.update_zq(kz, spec, data, freq, state.q, state.alpha,
                               axis_name=axis_name, active=state.active)
        state = state._replace(z=z, q=q)

        alpha = up.update_alpha(ka, spec, q, state.alpha, state.active)
        return state._replace(alpha=alpha)

    return step, (lambda s: _cal_lkh(spec, data, s, axis_name))


def build_marg_loglik(spec: ModelSpec, data: Dataset, axis_name=None,
                      tetra_tables=None):
    """`add_marg(state) -> state` filling `state.loglik_marg` with the
    pointwise per-individual log-likelihood that feeds WAIC and the
    corrected DIC.

    Deviance focus (the explicit model-choice focus, per chain draw):

    * diploid modes — the Z-MARGINALIZED likelihood
      (likelihood.py:marginal_site_loglik), the cleanest focus since the
      discrete Z integrates out in closed form;
    * tetraploid engine — no closed marginal over the latent genotype
      ordering exists, so the focus is the (z, geno)-CONDITIONAL
      pointwise likelihood (tetra/engine.py:_site_loglik summed per
      individual), i.e. each posterior draw scores the data conditional
      on that draw's latents.  This is the standard conditional-focus
      WAIC for latent-variable models and replaces the reference's
      degenerate -2 E[logL] ranking for `-ik -p 4` sweeps
      (InStruct.c:536-601 + result_analysis.c:403-411).

    The driver calls this only every ``Schedule.dic_every``-th stored step
    (holding the value constant in between is an unbiased subsampled
    mean), so the extra site pass costs ~nothing at the default
    thinning."""
    if spec.ploid == 4:
        from instruct_jax.tetra.engine import (build_tables,
                                               log_hwe_table,
                                               selfing_equilibrium,
                                               site_indv_loglik)
        tables = (tetra_tables if tetra_tables is not None
                  else build_tables(spec, data, with_candidates=False))

        def add_marg(state: McmcState) -> McmcState:
            log_hwe = log_hwe_table(tables, spec, state.freq, state.freq2)
            table = selfing_equilibrium(tables, log_hwe, state.rates)
            indv = up._psum(
                site_indv_loglik(tables, spec, data, state.freq,
                                 state.freq2, state.z, state.geno,
                                 table), axis_name)
            return state._replace(loglik_marg=indv)
        return add_marg

    if spec.mode == 0:
        def add_marg(state: McmcState) -> McmcState:
            ll = up._psum(lk.loglik_matrix_nopop_admix(data, state.freq),
                          axis_name)                       # [N, K]
            if state.active is not None:
                # padded K grid: the uniform mixture runs over the ACTIVE
                # slots only — inactive slots' freq is unconstrained
                # Dirichlet(1) noise and must not enter the marginal
                ll = jnp.where(state.active[None, :] > 0, ll, -jnp.inf)
                log_k = jnp.log(jnp.maximum(state.active.sum(), 1.0))
            else:
                log_k = jnp.log(float(spec.n_pops))
            indv = jax.nn.logsumexp(ll, axis=1) - log_k
            return state._replace(loglik_marg=indv)
        return add_marg

    def add_marg(state: McmcState) -> McmcState:
        gen = (state.gen.astype(jnp.float32) if spec.has_selfing else None)
        rates = state.rates if state.rates.size else None
        indv = lk.marginal_indv_loglik(spec, data, state.freq, state.q,
                                       gen, rates)
        indv = up._psum(indv, axis_name)
        return state._replace(loglik_marg=indv)

    return add_marg


def build_step(spec: ModelSpec, data: Dataset) -> Callable:
    """`step(state, key) -> state` with the log-likelihood always filled —
    the composition of :func:`build_step_parts`.  Use the parts directly
    (as the chain driver does) to skip cal_lkh on unsampled steps."""
    core, add_ll = build_step_parts(spec, data)

    def step(state: McmcState, key: jax.Array) -> McmcState:
        return add_ll(core(state, key))

    return step
