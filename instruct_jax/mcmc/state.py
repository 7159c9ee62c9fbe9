"""Sampler state pytree and initialisation.

The reference's per-step mutable state is the UPMCMC struct (mcmc.h, alloc at
mcmc.c:506-546).  Here it is an immutable NamedTuple of dense arrays; fields
that a mode does not use are zero-size so one type serves every mode and
`vmap`/`pjit` stay shape-polymorphic over chains.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from instruct_jax.config import ModelSpec
from instruct_jax.data.dataset import Dataset


class McmcState(NamedTuple):
    """One chain's sampler state (cf. UPMCMC, mcmc.h)."""

    freq: jnp.ndarray         # f32[K, L, A] — P (allele freqs per pop/locus)
    z: jnp.ndarray            # i8[N, S] per-copy pop assignments, flat
    #   (int8: K < 128 always; z is touched every pass so narrow dtype
    #   matters as much as for geno)
    #   S = L * ploid (modes 1-5; mode 0 uses zz instead and z is size-0)
    zz: jnp.ndarray           # i32[N] per-individual assignment (mode 0 only)
    q: jnp.ndarray            # f32[N, K] admixture proportions (modes 1-5)
    alpha: jnp.ndarray        # f32[] Dirichlet concentration of Q's prior
    rates: jnp.ndarray        # f32[R] selfing rates S or inbreeding F
    #   (R = K for modes 2/4/tetra, N for 3/5, 0 otherwise)
    ais_state: jnp.ndarray    # i32[R] 3-state flag of the adaptive
    #   independence sampler (dt_stat, mcmc.c:1524-1546); unused if back_refl
    gen: jnp.ndarray          # i32[N] selfing generations (modes 2/3)
    loglik_indv: jnp.ndarray  # f32[N] cal_lkh per-individual log-lik
    loglik_total: jnp.ndarray  # f32[]
    dpm_values: jnp.ndarray   # f32[N] DPM cluster-table values (modes 3/5
    #   with the DP prior; size-0 otherwise) — replaces DPMM.c's linked list
    dpm_counts: jnp.ndarray   # i32[N] table occupancy (0 = free slot)
    dpm_assign: jnp.ndarray   # i32[N] table slot of each individual
    prior_mu: jnp.ndarray     # f32[] normal-prior mean (modes 3/5, `-f 2`)
    prior_sigma2: jnp.ndarray  # f32[] normal-prior variance
    freq2: jnp.ndarray = None  # f32[K, L, A] second allele-frequency system
    #   (allotetraploid only — UPMCMC.freq2, mcmc.c:540-543)
    geno: jnp.ndarray = None   # i32[N, L*4] latent ordered genotype, flat
    #   (tetraploid only — UPMCMC.geno, mcmc.c:544)
    zcounts: jnp.ndarray = None  # f32[K, L, A] allele-pop counts of the
    #   current z (diploid modes 1-3) — carried so the fused Pallas step
    #   (kernels/fused_step.py) updates P without re-reading the site
    #   tensors; the XLA path recounts from z and leaves this untouched
    loglik_marg: jnp.ndarray = None  # f32[N] pointwise per-individual
    #   log-lik (diploid: Z-marginalized, likelihood.py:
    #   marginal_indv_loglik; tetraploid: (z, geno)-conditional,
    #   tetra/engine.py:_site_loglik — see step.build_marg_loglik for the
    #   focus), refreshed every Schedule.dic_every-th stored step and
    #   folded into the streaming moments — feeds the corrected DIC
    #   (E[logL] + plug-in) and the label-invariant WAIC.
    active: jnp.ndarray = None  # f32[K] active-pop mask (1.0 for pop slots
    #   in use, 0.0 for padding) — only set by the padded (chain x K)
    #   K-selection grid (kselect.py), where every replica shares K_max
    #   shapes and runs its own effective K.  The invariant is that q (and
    #   hence z, counts) put EXACTLY zero mass on inactive trailing slots:
    #   the Q Dirichlet draw masks its gamma variates (renormalizing over
    #   the active set is exact), and the z inverse-CDF never selects a
    #   zero-mass trailing category.  None (the default) = all pops active,
    #   masking code compiled out.


def _dt_stat(rates: jnp.ndarray) -> jnp.ndarray:
    """3-state classification of S/F: {0}, (0,1), {1} with eps=1e-3
    (dt_stat, mcmc.c:1524-1546)."""
    eps = 1e-3
    return jnp.where(rates <= eps, 0, jnp.where(rates >= 1.0 - eps, 2, 1))


def init_state(
    key: jax.Array,
    spec: ModelSpec,
    data: Dataset,
    init_rates: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
    active: Optional[jnp.ndarray] = None,
    tetra_tables=None,
) -> McmcState:
    """Draw the initial state for one chain.

    Mirrors the per-mode initialisation blocks: alpha ~ U[0,10]*
    (initial_chn, mcmc.c:479); S from the initial file or U[0,1]
    (read_init, initial.c:56-68 / mcmc.c:200-205); G ~ Geom capped
    (mcmc.c:196-199, 326-331); Z uniform then Q|Z (update_ZQ init_flag=1,
    mcmc.c:1122-1199).  P starts at the uniform simplex; the first
    update_P overwrites it before any use, matching the reference where the
    step loop leads with update_P.
    """
    if spec.ploid == 4:
        from instruct_jax.tetra.engine import init_tetra_state
        return init_tetra_state(key, spec, data, init_rates,
                                axis_name=axis_name, tables=tetra_tables)

    n = data.geno.shape[0]
    l, p = data.n_loci, data.ploid
    k = spec.n_pops
    a = data.allele_valid.shape[1]
    r = spec.n_rates(n)
    kz, kq, kal, ks, kg = jax.random.split(key, 5)

    valid_f = data.allele_valid.astype(jnp.float32)
    freq = valid_f / jnp.maximum(valid_f.sum(-1, keepdims=True), 1.0)
    freq = jnp.broadcast_to(freq[None], (k, l, a)).astype(jnp.float32)

    # uniform initial assignments over the ACTIVE pop slots; active pops
    # occupy the leading slots (kselect padded grid invariant), so the
    # masked draw is floor(u * n_active) — no K-trailing tensor.
    def _unif_pops(kk, shape, dtype):
        if active is None:
            return jax.random.randint(kk, shape, 0, k, dtype=dtype)
        n_act = jnp.maximum(active.sum(), 1.0)
        u = jax.random.uniform(kk, shape)
        return jnp.floor(u * n_act).astype(dtype)

    if spec.mode == 0 and spec.ploid == 2:
        zz = _unif_pops(kz, (n,), jnp.int32)
        z = jnp.zeros((0, 0), jnp.int8)
        q = jnp.zeros((0, 0), jnp.float32)
        alpha = jnp.zeros((), jnp.float32)
    else:
        from instruct_jax.mcmc import updates as up  # runtime: no cycle
        zz = jnp.zeros((0,), jnp.int32)
        # z draws are site-local (shard-folded key under loci sharding);
        # q/alpha are replicated (global psummed counts, unfolded keys)
        z = _unif_pops(up.shard_key(kz, axis_name), (n, l * p), jnp.int8)
        counts = up._psum(masked_z_counts(z, data, k), axis_name)
        alpha = jax.random.uniform(kal) * spec.alpha_prior_max
        q = _dirichlet(kq, counts + alpha,
                       None if active is None else active > 0)

    use_dpm = (spec.priors.family.value == "dpm" and spec.mode in (3, 5))
    if use_dpm:
        # Initial rates come from the CRP prior draw (init_DP,
        # DPMM.c:124-161; consumed at mcmc.c:318-324, 407-413).
        from instruct_jax.mcmc.dpm import init_dpm
        table = init_dpm(ks, spec.priors.alpha_dpm, n)
        rates = table.values[table.assign]
        dpm_values, dpm_counts, dpm_assign = table
    elif r > 0:
        if init_rates is None:
            rates = jax.random.uniform(ks, (r,))
        else:
            rates = jnp.asarray(init_rates, jnp.float32).reshape(r)
        dpm_values = jnp.zeros((0,), jnp.float32)
        dpm_counts = jnp.zeros((0,), jnp.int32)
        dpm_assign = jnp.zeros((0,), jnp.int32)
    else:
        rates = jnp.zeros((0,), jnp.float32)
        dpm_values = jnp.zeros((0,), jnp.float32)
        dpm_counts = jnp.zeros((0,), jnp.int32)
        dpm_assign = jnp.zeros((0,), jnp.int32)
    ais_state = _dt_stat(rates).astype(jnp.int32)

    if spec.has_selfing:
        if spec.mode == 2:
            # gen ~ Geom(ran1()) i.e. geometric with a *random* success prob
            # (mcmc.c:196-199).
            u = jax.random.uniform(kg, (n,), minval=1e-6, maxval=1.0 - 1e-6)
            psucc = jax.random.uniform(jax.random.fold_in(kg, 1), (n,),
                                       minval=1e-6, maxval=1.0 - 1e-6)
        else:
            # mode 3: gen ~ Geom(1 - s_i) (mcmc.c:329-331).
            u = jax.random.uniform(kg, (n,), minval=1e-6, maxval=1.0 - 1e-6)
            psucc = jnp.clip(1.0 - rates, 1e-6, 1.0 - 1e-6)
        gen = 1 + jnp.floor(jnp.log(u) / jnp.log1p(-psucc)).astype(jnp.int32)
        gen = jnp.clip(gen, 1, spec.gen_cap)
    else:
        gen = jnp.zeros((0,), jnp.int32)

    zcounts = None
    if spec.mode in (1, 2, 3, 4, 5):
        from instruct_jax.mcmc import updates as up  # runtime: no cycle
        zcounts = up.allele_pop_counts(spec, data, z, zz)

    return McmcState(
        freq=freq, z=z, zz=zz, q=q, alpha=alpha, rates=rates,
        ais_state=ais_state, gen=gen,
        loglik_indv=jnp.zeros((n,), jnp.float32),
        loglik_total=jnp.zeros((), jnp.float32),
        dpm_values=dpm_values, dpm_counts=dpm_counts, dpm_assign=dpm_assign,
        prior_mu=jnp.asarray(spec.priors.normal_mu0, jnp.float32),
        prior_sigma2=jnp.asarray(spec.priors.normal_sigmasqr0, jnp.float32),
        zcounts=zcounts,
        loglik_marg=jnp.zeros((n,), jnp.float32),
        active=active,
    )


def _dirichlet(key, conc, valid=None):
    safe = jnp.maximum(conc, 1e-6)
    if valid is not None:
        safe = jnp.where(valid, safe, 1.0)
    g = jax.random.gamma(key, safe)
    if valid is not None:
        g = jnp.where(valid, g, 0.0)
    return g / jnp.maximum(g.sum(-1, keepdims=True), 1e-30)


def masked_z_counts(z, data: Dataset, n_pops: int) -> jnp.ndarray:
    """qqnum f32[N, K]: valid allele copies of each individual assigned to
    each pop (the Q-count loop of update_ZQ, mcmc.c:1176-1194).  z is flat
    [N, S]; the K axis is a static loop of masked reductions (layout:
    never a K-trailing one-hot)."""
    valid = jnp.tile(data.site_valid, (1, data.ploid))       # [N, S]
    cols = [jnp.where(valid & (z == kk), 1.0, 0.0).sum(axis=1)
            for kk in range(n_pops)]
    return jnp.stack(cols, axis=1)
