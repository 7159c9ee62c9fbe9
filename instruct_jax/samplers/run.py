"""High-level entry for the alternative inference engines (HMC / SVI / SMC)
over the marginalized model, mirroring `run_mcmc`'s call shape so the CLI
can swap engines with one flag."""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.dataset import Dataset
from instruct_jax.samplers.hmc import HmcConfig, run_hmc
from instruct_jax.samplers.potential import MarginalModel
from instruct_jax.samplers.smc import SmcConfig, run_smc
from instruct_jax.samplers.svi import SviConfig, run_svi


@dataclasses.dataclass
class SamplerResult:
    method: str
    s_mean: np.ndarray       # [K] (mode 2) or [0]
    s_var: np.ndarray
    q_mean: np.ndarray       # [N, K]
    q_var: np.ndarray
    extra: dict


def _svi_warm_start(model: MarginalModel, key, n_chains: int):
    """Per-chain initial positions for the gradient samplers: one short
    SVI fit to locate the dominant posterior basin, then small per-chain
    jitter.  Mixture posteriors are multimodal (label permutations +
    genuine local modes — e.g. the mode-4 F posterior traps cold-started
    trajectories at a spurious interior mode); a few hundred variational
    steps reliably land in the main basin and NUTS/HMC then agree with
    the Gibbs engine (tests/test_nuts.py)."""
    init = model.init(key)
    mu, _, _ = run_svi(model.log_joint, init, jax.random.fold_in(key, 97),
                       SviConfig(n_steps=400, learning_rate=0.05))

    def jitter(k):
        leaves, treedef = jax.tree.flatten(mu)
        ks = jax.random.split(k, len(leaves))
        return jax.tree.unflatten(
            treedef, [m + 0.02 * jax.random.normal(kk, m.shape)
                      for kk, m in zip(ks, leaves)])

    return jax.vmap(jitter)(jax.random.split(
        jax.random.fold_in(key, 98), n_chains))


def run_sampler(
    method: str,
    data: Dataset,
    spec: ModelSpec,
    sched: Schedule,
    key: jax.Array,
) -> SamplerResult:
    model = MarginalModel(spec, data)
    n_chains = max(1, sched.n_chains)

    if method == "hmc":
        cfg = HmcConfig(n_warmup=min(500, max(50, sched.burnin)),
                        n_samples=min(1000, max(100, sched.n_stored)),
                        n_leapfrog=16, init_step=0.02)
        inits = _svi_warm_start(model, key, n_chains)

        def one_chain(k, init):
            return run_hmc(model.potential, init, jax.random.fold_in(k, 1),
                           cfg, collect=lambda p: (model.selfing_rates(p),
                                                   model.admixture(p)))

        keys = jax.random.split(key, n_chains)
        (s_draws, q_draws), accept, _ = jax.vmap(one_chain)(keys, inits)
        s = np.asarray(s_draws).reshape(-1, s_draws.shape[-1])
        q = np.asarray(q_draws).reshape(-1, *q_draws.shape[2:])
        return SamplerResult("hmc", s.mean(0), s.var(0), q.mean(0),
                             q.var(0),
                             {"accept_rate": np.asarray(accept).tolist()})

    if method == "nuts":
        from instruct_jax.samplers.nuts import NutsConfig, run_nuts
        cfg = NutsConfig(n_warmup=min(500, max(50, sched.burnin)),
                         n_samples=min(1000, max(100, sched.n_stored)),
                         max_depth=8, init_step=0.02)
        inits = _svi_warm_start(model, key, n_chains)

        def one_chain(k, init):
            return run_nuts(model.potential, init,
                            jax.random.fold_in(k, 1), cfg,
                            collect=lambda p: (model.selfing_rates(p),
                                               model.admixture(p)))

        keys = jax.random.split(key, n_chains)
        (s_draws, q_draws), accept, _ = jax.vmap(one_chain)(keys, inits)
        s = np.asarray(s_draws).reshape(-1, s_draws.shape[-1])
        q = np.asarray(q_draws).reshape(-1, *q_draws.shape[2:])
        return SamplerResult("nuts", s.mean(0), s.var(0), q.mean(0),
                             q.var(0),
                             {"accept_rate": np.asarray(accept).tolist()})

    if method == "svi":
        cfg = SviConfig(n_steps=min(2000, max(300, sched.n_iter)),
                        learning_rate=0.02)
        init = model.init(key)
        mu, log_sigma, elbo = run_svi(model.log_joint, init,
                                      jax.random.fold_in(key, 1), cfg)
        # posterior moments by sampling the variational distribution
        ks = jax.random.split(jax.random.fold_in(key, 2), 256)

        def draw(k):
            leaves, treedef = jax.tree.flatten(mu)
            kk = jax.random.split(k, len(leaves))
            z = jax.tree.unflatten(
                treedef,
                [m + jnp.exp(ls) * jax.random.normal(k2, m.shape)
                 for k2, m, ls in zip(kk, leaves, jax.tree.leaves(log_sigma))])
            return model.selfing_rates(z), model.admixture(z)

        s_d, q_d = jax.vmap(draw)(ks)
        s_d, q_d = np.asarray(s_d), np.asarray(q_d)
        return SamplerResult("svi", s_d.mean(0), s_d.var(0), q_d.mean(0),
                             q_d.var(0),
                             {"final_elbo": float(np.asarray(elbo)[-1])})

    if method == "smc":
        n_part = max(64, n_chains * 32)
        cfg = SmcConfig(n_particles=n_part, n_temps=20, n_mh_steps=5,
                        rw_scale=0.05)
        keys = jax.random.split(key, n_part)
        init = jax.vmap(model.init)(keys)
        parts, logz, ess = run_smc(model.log_joint, model.log_prior, init,
                                   jax.random.fold_in(key, 1), cfg)
        s_d = np.asarray(jax.vmap(model.selfing_rates)(parts))
        q_d = np.asarray(jax.vmap(model.admixture)(parts))
        return SamplerResult("smc", s_d.mean(0), s_d.var(0), q_d.mean(0),
                             q_d.var(0),
                             {"log_evidence": float(logz),
                              "min_ess": float(np.asarray(ess).min())})

    raise ValueError(f"unknown sampler {method}")


def write_sampler_report(path: str, panel, spec: ModelSpec,
                         result: SamplerResult, argv=None) -> None:
    with open(path, "w") as fh:
        fh.write(f"instruct_jax {result.method.upper()} inference "
                 f"(marginalized model, mode {spec.mode})\n")
        if argv:
            fh.write("Command line arguments:\n    " + " ".join(argv)
                     + "\n")
        for k, v in result.extra.items():
            fh.write(f"{k} = {v}\n")
        if result.s_mean.size:
            fh.write("\nThe Posterior distribution of Selfing Rates:\n")
            fh.write("\t\tMean\tVar\n")
            for j in range(result.s_mean.size):
                fh.write(f"Cluster {j + 1}\t{result.s_mean[j]:.3f}\t"
                         f"{result.s_var[j]:.3f}\n")
        fh.write("\nInferred ancestry of individuals:\n")
        for i in range(result.q_mean.shape[0]):
            name = (panel.indv_names[i] if panel.indv_names else str(i + 1))
            fh.write(f"{i + 1}\t{name}\t: "
                     + " ".join(f"{v:.3f}" for v in result.q_mean[i])
                     + "\n")
