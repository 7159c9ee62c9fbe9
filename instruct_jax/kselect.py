"""DIC-based selection of the number of subpopulations K.

Mirrors inf_K_val (InStruct.c:536-601): sweep K in [n_small, n_large]
(default upper bound N^0.3 + 1, InStruct.c:547-548), run all chains per K,
pick the K minimising the per-K minimum DIC over chains (InStruct.c:588-592).

Two deliberate departures from the reference, per SURVEY.md §2.1:

* Selection ranks on an information criterion with a REAL complexity
  penalty.  The reference's DIC degenerates to -2 E[logL] (its "plug-in"
  term re-uses the posterior-mean log-lik, result_analysis.c:403-411), so
  it can never prefer a smaller K.  We compute the corrected DIC
  (RunResult.dic: Dbar + pD, plug-in at the posterior means) AND WAIC
  (RunResult.waic) and rank on **WAIC under the one-standard-error rule**
  (smallest K whose chain-mean WAIC is within one SE of the minimum,
  Hastie et al., ESL §7.10): mixture posteriors are singular, and when K
  exceeds the truth the redundant clusters wander — blurring the
  posterior-mean plug-in so DIC's pD collapses exactly when it must grow —
  or capture single individuals, the influential-fit regime WAIC's
  quadratic penalty undercounts; past the true K both criteria therefore
  plateau within their sampling noise instead of rising.  The 1-SE rule
  reads the plateau: measured on synthetic K=2/3 panels it recovers the
  generating K across seeds where both raw minima drift to K_max
  (tests/test_dic.py).  All columns (WAIC+SE, corrected DIC+pD,
  reference DIC) are reported per K.
* Initial S/F values from the `-i` file are re-used across every K run
  (InStruct.c:563 passes the same `initial`): per-pop rate vectors are
  sliced/cycled to each K's width.

The sweep runs as ONE padded (chain x K) grid by default (survey §3.4
"K values are just more parallel replicas"): every K value's chains are
folded into the chains axis of a single run at K_max shapes with a
per-replica active-pop mask (`run_mcmc(active_pops=...)`), so the whole
grid costs one compile and saturates the device/mesh together.  Per-K
results are then sliced back out of the replica axis (padding columns
hold exact zeros, so DIC/WAIC/GR are unchanged).  Every diploid mode
(0-5) K-sweeps in one compile; tetraploid panels and loci-sharded
meshes fall back to the per-K sequential loop (one jit specialisation
per K).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import numpy as np

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.dataset import Dataset
from instruct_jax.mcmc.driver import RunResult, run_mcmc


@dataclasses.dataclass
class KSelectResult:
    best_k: int
    dic: Dict[int, np.ndarray]            # per-K, per-chain corrected DIC
    results: Dict[int, RunResult]
    dic_reference: Dict[int, np.ndarray]  # reference-formula DIC per K/chain
    p_d: Dict[int, Optional[np.ndarray]]  # effective parameter count
    gelman_rubin: Dict[int, Optional[float]]  # per-K GR of the log-lik trace
    waic: Dict[int, Optional[np.ndarray]] = None  # per-K, per-chain WAIC
    #   (the selection statistic when available)
    waic_se: Dict[int, Optional[float]] = None    # per-K WAIC standard error
    n_small: int = 1
    n_large: int = 1


def _rates_for_k(init_rates, r: int):
    """Adapt a [n_chains, R0] initial-rates matrix to a K run needing R
    values per chain: slice when wide enough, cycle columns otherwise
    (the reference reuses the same `initial` across K, InStruct.c:563)."""
    if init_rates is None or r == 0:
        return None
    init_rates = np.asarray(init_rates)
    r0 = init_rates.shape[1]
    if r0 >= r:
        return init_rates[:, :r]
    reps = -(-r // r0)
    return np.tile(init_rates, (1, reps))[:, :r]


def _slice_result(res: RunResult, rows: slice, k: int,
                  spec: ModelSpec) -> RunResult:
    """Per-K view of the padded grid run: select this K's chain replicas
    and truncate the padded pop axes back to k.  Valid because inactive
    slots carry exact zeros in q (and its moments) and are never
    referenced by any likelihood term."""
    def trunc(stats):
        out = stats._replace(q=stats.q[:, :, :k])
        if spec.rates_are_per_pop:
            out = out._replace(rates=out.rates[:, :k])
        if out.freq.ndim == 4:
            out = out._replace(freq=out.freq[:, :k])
        return out

    accum = jax.tree.map(lambda x: x[rows], res.accum)
    accum = accum._replace(mean=trunc(accum.mean),
                           mean_sq=trunc(accum.mean_sq))
    final = jax.tree.map(lambda x: x[rows], res.final_state)
    plug = None if res.plugin_ll is None else res.plugin_ll[rows]
    return RunResult(accum=accum, final_state=final,
                     n_retries=res.n_retries, plugin_ll=plug)


def infer_k(
    data: Dataset,
    spec: ModelSpec,
    sched: Schedule,
    key: jax.Array,
    n_small: int = 1,
    n_large: int = 0,
    mesh=None,
    init_rates=None,
    grid: bool = True,
    **run_kwargs,
) -> KSelectResult:
    if n_large < 1 or n_small < 1 or n_small > n_large:
        n_small = 1
        n_large = int(data.n_indv ** 0.3) + 1  # InStruct.c:547-548
    # the corrected DIC needs the posterior-mean P for its plug-in pass
    # (diploid AND tetraploid — the tetra plug-in conditions on the final
    # latents, driver._plugin_tetra_loglik)
    run_kwargs.setdefault("track_freq", True)
    dic: Dict[int, np.ndarray] = {}
    dic_ref: Dict[int, np.ndarray] = {}
    waic: Dict[int, Optional[np.ndarray]] = {}
    waic_se: Dict[int, Optional[float]] = {}
    p_d: Dict[int, Optional[np.ndarray]] = {}
    gr: Dict[int, Optional[float]] = {}
    results: Dict[int, RunResult] = {}
    ks_list = list(range(n_small, n_large + 1))
    # run_mcmc rejects active_pops together with loci sharding, so a mesh
    # whose "data" axis is nontrivial falls back to the sequential per-K
    # loop instead of raising (ADVICE r4)
    mesh_data = 1
    if mesh is not None:
        from instruct_jax.parallel.mesh import DATA_AXIS
        mesh_data = mesh.shape.get(DATA_AXIS, 1)
    use_grid = (grid and spec.ploid == 2 and len(ks_list) > 1
                and mesh_data == 1)

    if use_grid:
        # one padded (chain x K) run: replicas i*C..(i+1)*C run K = ks[i]
        nc = sched.n_chains
        k_max = n_large
        spec_pad = dataclasses.replace(spec, n_pops=k_max)
        r_max = spec_pad.n_rates(data.n_indv)
        reps = len(ks_list) * nc
        active = np.zeros((reps, k_max), np.float32)
        rates_grid = None
        if init_rates is not None and r_max > 0:
            rates_grid = np.zeros((reps, r_max), np.float32)
        for i, kv in enumerate(ks_list):
            active[i * nc:(i + 1) * nc, :kv] = 1.0
            if rates_grid is not None:
                # the reference reuses the same `-i` starts for every K
                # (InStruct.c:563); inactive slots keep zeros
                r_k = (kv if spec.rates_are_per_pop else r_max)
                rk = _rates_for_k(init_rates, r_k)
                rates_grid[i * nc:(i + 1) * nc, :r_k] = rk
        sched_grid = dataclasses.replace(sched, n_chains=reps)
        res_all = run_mcmc(data, spec_pad, sched_grid, key,
                           init_rates=rates_grid, active_pops=active,
                           mesh=mesh, **run_kwargs)
        for i, kv in enumerate(ks_list):
            res = _slice_result(res_all, slice(i * nc, (i + 1) * nc), kv,
                                spec)
            results[kv] = res
            dic[kv] = res.dic()
            dic_ref[kv] = res.dic_reference()
            waic[kv] = res.waic()
            waic_se[kv] = res.waic_se()
            p_d[kv] = res.p_d()
            if nc > 1:
                from instruct_jax.diagnostics import gelman_rubin
                gr[kv] = float(gelman_rubin(
                    np.asarray(res.accum.convg_ld)))
            else:
                gr[kv] = None
        return _pick_best(dic, waic, waic_se, results, dic_ref, p_d, gr,
                          n_small, n_large)

    for k in ks_list:
        spec_k = dataclasses.replace(spec, n_pops=k)
        res = run_mcmc(data, spec_k, sched, jax.random.fold_in(key, k),
                       init_rates=_rates_for_k(init_rates,
                                               spec_k.n_rates(data.n_indv)),
                       mesh=mesh, **run_kwargs)
        results[k] = res
        dic[k] = res.dic()
        dic_ref[k] = res.dic_reference()
        waic[k] = res.waic()
        waic_se[k] = res.waic_se()
        p_d[k] = res.p_d()
        if sched.n_chains > 1:
            from instruct_jax.diagnostics import gelman_rubin
            gr[k] = float(gelman_rubin(np.asarray(res.accum.convg_ld)))
        else:
            gr[k] = None
    return _pick_best(dic, waic, waic_se, results, dic_ref, p_d, gr,
                      n_small, n_large)


def _pick_best(dic, waic, waic_se, results, dic_ref, p_d, gr,
               n_small, n_large) -> KSelectResult:
    # rank on the chain-mean WAIC under the one-standard-error rule when
    # every K produced one (diploid); else min-DIC over chains, as
    # inf_K_val does (InStruct.c:588-592)
    if all(w is not None for w in waic.values()):
        wmean = {k: float(w.mean()) for k, w in waic.items()}
        k_min = min(wmean, key=wmean.get)
        tol = wmean[k_min] + (waic_se[k_min] or 0.0)
        best_k = min(k for k, w in wmean.items() if w <= tol)
    else:
        best_k = min(dic, key=lambda k: dic[k].min())
    return KSelectResult(best_k=best_k, dic=dic, results=results,
                         dic_reference=dic_ref, p_d=p_d, gelman_rubin=gr,
                         waic=waic, waic_se=waic_se,
                         n_small=n_small, n_large=n_large)
