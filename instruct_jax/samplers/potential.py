"""Differentiable marginalized posterior for gradient-based inference.

The Gibbs engine (mcmc/) mirrors the reference's data augmentation (explicit
Z, G).  For HMC/NUTS, SVI and SMC we instead marginalize the discrete
latents exactly:

  * Z (per-copy ancestry) is summed out per allele copy:
    p(a | q_i, P) = sum_k q_ik P[k, l, a] — the "expectation way" genotype
    frequency the reference computes at mcmc.c:1739-1749;
  * G (selfing generations) is summed over 1..gen_cap against its geometric
    prior Geom(1 - sbar_i), where sbar_i = sum_k q_ik s_k (mcmc.c:1063-1066)
    — a 50-term logsumexp replacing the latent-variable MH.

The remaining parameters are continuous and unconstrained:
  phi_P   f32[K, L, A]  — softmax rows give P
  phi_q   f32[N, K]     — softmax rows give Q
  phi_s   f32[K]        — sigmoid gives S          (mode 2 only)
  phi_a   f32[]         — softplus gives alpha

giving a fully differentiable log-joint whose gradients XLA fuses into a
few [N, L]-shaped kernels.  This is a new capability on top of the
reference (BASELINE.json asks for NUTS/HMC + SVI + SMC alternatives).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from instruct_jax.config import ModelSpec
from instruct_jax.data.dataset import Dataset

# f32 products feeding MH ratios / log-likelihoods: never TF32
_HI = jax.lax.Precision.HIGHEST

_EPS = 1e-30


class MarginalParams(NamedTuple):
    phi_p: jnp.ndarray
    phi_q: jnp.ndarray
    phi_s: jnp.ndarray
    phi_a: jnp.ndarray


class MarginalModel:
    """log_joint / constrain / init for the marginalized admixture model
    family, modes 1-5 (diploid):

      mode 1: (P, Q, alpha)
      mode 2: + S per pop        — G summed out over 1..gen_cap
      mode 3: + S per individual — same G marginalization, sbar_i = s_i
      mode 4: + F per pop        — Z marginalized exactly via the rank-1
      mode 5: + F per individual   2-copy mixture (marginal_site_loglik)

    Mode 0 (one discrete assignment per individual, no Q/alpha) stays on
    the Gibbs engine; the DPM prior is likewise Gibbs-only (its cluster
    table is discrete).  Modes 3/5 use the flat U(0,1) base prior on the
    per-individual rates — the hierarchical-normal/DPM priors remain
    Gibbs-engine features."""

    def __init__(self, spec: ModelSpec, data: Dataset):
        if spec.mode not in (1, 2, 3, 4, 5):
            raise ValueError(
                "marginalized potential supports the admixture modes 1-5 "
                "(mode 0's one-hot assignment model is Gibbs-only)")
        if spec.ploid != 2:
            raise ValueError("marginalized potential is diploid-only")
        self.spec = spec
        self.data = data
        self.gen_cap = spec.gen_cap
        self.n_rates = spec.n_rates(data.n_indv)

    def init(self, key) -> MarginalParams:
        k = self.spec.n_pops
        n = self.data.geno.shape[0]
        l = self.data.n_loci
        a = self.data.allele_valid.shape[1]
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return MarginalParams(
            phi_p=0.1 * jax.random.normal(k1, (k, l, a)),
            phi_q=0.1 * jax.random.normal(k2, (n, k)),
            phi_s=0.1 * jax.random.normal(k3, (self.n_rates,)),
            phi_a=jnp.zeros(()),
        )

    def constrain(self, params: MarginalParams):
        av = self.data.allele_valid[None]
        logits = jnp.where(av, params.phi_p, -1e30)
        p = jax.nn.softmax(logits, axis=-1)
        q = jax.nn.softmax(params.phi_q, axis=-1)
        s = jax.nn.sigmoid(params.phi_s)
        alpha = jax.nn.softplus(params.phi_a) + 1e-3
        return p, q, s, alpha

    def log_lik(self, params: MarginalParams) -> jnp.ndarray:
        """Marginalized data log-likelihood (Z and, for mode 2, G summed
        out)."""
        from instruct_jax.model import likelihood as lk
        spec, data = self.spec, self.data
        p, q, s, alpha = self.constrain(params)
        hom, valid = data.hom, data.site_valid

        # per-copy mixture probs (flat [N, S], K as a static loop — layout)
        m = lk.mixture_copy_probs(p, data, q)
        m0, m1 = lk.split_copies(m, data.ploid)

        if spec.mode == 1:
            site = jnp.log(jnp.maximum(
                jnp.where(hom, m0 * m1, 2.0 * m0 * m1), _EPS))
            ll = jnp.where(valid, site, 0.0).sum()
        elif spec.mode in (4, 5):
            # F modes: Z marginalized exactly via the rank-1 2-copy
            # mixture collapse (likelihood.marginal_site_loglik — the same
            # deviance focus the corrected DIC evaluates)
            ll = lk.marginal_indv_loglik(spec, data, p, q, None, s).sum()
        else:
            # modes 2/3, G-marginalized: ll_i = logsumexp_g
            #   [ log Geom(g|1-sbar_i) + sum_l log genofreq(m0, m1, hom, g) ]
            gens = jnp.arange(1, self.gen_cap + 1, dtype=jnp.float32)
            w = jnp.exp2(1.0 - gens)                          # [G]
            hom_f = hom[..., None]
            gf = jnp.where(
                hom_f,
                m0[..., None] * m0[..., None]
                + m0[..., None] * (1 - m0[..., None]) * (1 - w),
                2.0 * m0[..., None] * m1[..., None] * w)      # [N, L, G]
            site = jnp.log(jnp.maximum(gf, _EPS))
            per_gen = jnp.where(valid[..., None], site, 0.0).sum(1)  # [N, G]
            # mode 2: sbar_i = sum_k q_ik s_k (mcmc.c:1063-1066);
            # mode 3: sbar_i = s_i (mcmc.c:1069)
            sbar = (jnp.dot(q, s, precision=_HI) if spec.mode == 2
                    else s)
            sbar = jnp.clip(sbar, 1e-6, 1.0 - 1e-6)           # [N]
            # truncated geometric prior on 1..cap, renormalized
            log_prior = ((gens - 1.0)[None, :] * jnp.log(sbar)[:, None]
                         + jnp.log1p(-sbar)[:, None])
            log_prior -= jax.nn.logsumexp(log_prior, axis=1, keepdims=True)
            ll = jax.nn.logsumexp(per_gen + log_prior, axis=1).sum()
        return ll

    def log_prior(self, params: MarginalParams) -> jnp.ndarray:
        """Prior + change-of-variable terms in unconstrained space."""
        spec = self.spec
        _p, q, s, alpha = self.constrain(params)
        # priors: P rows ~ Dir(1) (constant); q ~ Dir(alpha) symmetric;
        # s ~ U(0,1) via sigmoid Jacobian; alpha ~ U(0, 10].
        k = spec.n_pops
        n = q.shape[0]
        lp_q = (n * (jax.lax.lgamma(k * alpha) - k * jax.lax.lgamma(alpha))
                + (alpha - 1.0) * jnp.log(jnp.maximum(q, _EPS)).sum())
        # change-of-variable Jacobians so the target is the posterior in
        # unconstrained space
        jac_s = jnp.log(jnp.maximum(s * (1 - s), _EPS)).sum()
        jac_a = jnp.log(jnp.maximum(jax.nn.sigmoid(params.phi_a), _EPS))
        # softmax Jacobians for p and q are improper (overparameterized);
        # a weak Gaussian anchor keeps the flat direction integrable.
        anchor = -0.5e-3 * ((params.phi_p ** 2).sum()
                            + (params.phi_q ** 2).sum())
        penal_alpha = jnp.where(alpha > self.spec.alpha_prior_max,
                                -1e3 * (alpha - self.spec.alpha_prior_max),
                                0.0)
        return lp_q + jac_s + jac_a + anchor + penal_alpha

    def log_joint(self, params: MarginalParams) -> jnp.ndarray:
        return self.log_lik(params) + self.log_prior(params)

    def potential(self, params: MarginalParams) -> jnp.ndarray:
        return -self.log_joint(params)

    def selfing_rates(self, params: MarginalParams) -> jnp.ndarray:
        return jax.nn.sigmoid(params.phi_s)

    def admixture(self, params: MarginalParams) -> jnp.ndarray:
        return jax.nn.softmax(params.phi_q, axis=-1)
