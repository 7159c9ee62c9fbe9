"""North-star benchmark: effective samples / second for selfing rates S.

Panel: 1000 individuals x 10k loci, K=3, mode 2 (admixture + pop-level
selfing) — the BASELINE.json target config.  Runs the fused MCMC step on the
available accelerator with several vmapped chains, measures

  * chain-steps/second (throughput of the full Gibbs sweep), and
  * ESS/step of the S parameters from an on-device trace,

and reports ESS/sec = throughput x ESS/step summed over chains and S params.

``vs_baseline`` is the speedup in chain-iterations/sec over the measured
single-core C reference on the same panel (see BASELINE.md "Measured
baseline"); both samplers are the same Gibbs/MH family so per-iteration ESS
is comparable by construction.

Prints exactly one JSON line.
"""

import argparse
import json
import sys
import time

import numpy as np

# Measured on this machine (2-vCPU host, gcc -O2, single thread):
# reference InStruct mode 2 on the 1000x10k K=3 panel — see BASELINE.md and
# scripts/measure_c_baseline.py.
C_BASELINE_ITERS_PER_SEC = None  # filled from BASELINE.md at runtime


def read_c_baseline() -> float:
    import re
    from pathlib import Path
    text = (Path(__file__).parent / "BASELINE.md").read_text()
    m = re.search(r"measured_c_iters_per_sec\s*=\s*([\d.eE+-]+)", text)
    if not m:
        return float("nan")
    return float(m.group(1))


def run_trace_windows(vblock, states, keys, fold, t_block, chains,
                      min_trace_steps=0, min_windows=2, max_windows=8,
                      tol=0.03):
    """Collect the ESS trace AND a trustworthy throughput number.

    Round 4 post-mortem (VERDICT r4, Weak #1): the headline
    chain-steps/s used to come from ONE 50-step block (~0.15 s wall),
    which swung +-12% on dispatch/timing noise and produced a phantom
    11% regression.  Here the throughput is derived from multi-second
    WINDOWS of the long ESS trace itself, and the number is only
    recorded once two consecutive windows agree within ``tol`` (3%);
    otherwise more windows are run (up to ``max_windows``) and the
    report carries the window spread so disagreement is visible rather
    than silent.

    Each window = ``blocks_per_window`` compiled scan blocks; device
    sync (block_until_ready) at window boundaries only, so the window
    wall is dominated by device compute, not host dispatch.

    Returns (trace [C, T_total, ...], steps_per_sec_total, windows list).
    The trace is concatenated along the STEP axis (axis 1 — vmapped
    chain_blocks return [C, t_block, ...]); earlier rounds concatenated
    the [C, T, K] blocks along axis 0 and then indexed the result as
    [T, C, K], so the "per-chain" ESS series actually interleaved chains
    and block-local step indices — near-iid chains made the number land
    in the right ballpark, but it was not the statistic it claimed to be.
    """
    import jax
    # pick a window size of >= ~2 s of device time: calibrate from one
    # synced block
    t0 = time.time()
    states, tr0 = jax.block_until_ready(vblock(states, fold(keys, 0)))
    dt0 = max(time.time() - t0, 1e-3)
    blocks_per_window = max(1, int(2.0 / dt0))
    traces = [np.asarray(tr0)]
    windows = []
    b = 1
    while len(windows) < max_windows:
        t0 = time.time()
        for _ in range(blocks_per_window):
            states, tr = vblock(states, fold(keys, b))
            traces.append(np.asarray(tr))
            b += 1
        jax.block_until_ready(states)
        wall = time.time() - t0
        windows.append(t_block * blocks_per_window * chains / wall)
        if len(windows) >= min_windows and b * t_block >= min_trace_steps:
            w1, w2 = windows[-2], windows[-1]
            if abs(w1 - w2) / max(w1, w2) <= tol:
                break
    trace = np.concatenate(traces, axis=1)
    # headline throughput: total steps over the agreeing (last two)
    # windows — per-step rate of the long window, not a micro-burst
    steps_per_sec = float(np.mean(windows[-2:]))
    return trace, steps_per_sec, windows


def bench_tetra(args):
    """Tetraploid benchmark (--tetra auto|allo): 500 x 5k K=3 panel,
    measures chain-steps/s of the full ploid-4 sweep (poly_geno.c engine
    rebuilt in tetra/engine.py) and ESS/s of the per-pop selfing rates.
    Prints one JSON line; results recorded in BASELINE.md."""
    import jax
    import jax.numpy as jnp
    from instruct_jax.cache import enable_compile_cache
    enable_compile_cache()

    from instruct_jax.config import ModelSpec
    from instruct_jax.data.synthetic import synthetic_tetra_panel
    from instruct_jax.diagnostics import effective_sample_size
    from instruct_jax.mcmc.state import init_state
    from instruct_jax.mcmc.step import build_step_parts

    if args.quick:
        n, l, k = 100, 500, 2
        t_measure, t_trace = 20, 60
    else:
        n, l, k = 500, 5000, 3
        t_measure, t_trace = 30, 600
    autopoly = args.tetra != "allo"
    panel = synthetic_tetra_panel(n_indv=n, n_loci=l, n_pops=k,
                                  n_alleles=args.tetra_alleles,
                                  autopoly=autopoly, seed=7)
    spec = ModelSpec(mode=2, ploid=4, n_pops=k, autopoly=autopoly,
                     s_subsweeps=args.tetra_subsweeps)
    step_core, add_loglik = build_step_parts(spec, panel.data)
    c = args.chains
    thinning = 10

    def chain_block(state, key_steps):
        def body(st, i):
            st = step_core(st, jax.random.fold_in(key_steps, i))
            st = jax.lax.cond((i + 1) % thinning == 0, add_loglik,
                              lambda s: s, st)
            return st, st.rates
        return jax.lax.scan(body, state,
                            jnp.arange(t_measure, dtype=jnp.int32))

    vblock = jax.jit(jax.vmap(chain_block))
    keys = jax.random.split(jax.random.key(0), c)
    states = jax.vmap(lambda kk: init_state(kk, spec, panel.data))(keys)
    states, _ = jax.block_until_ready(vblock(states, keys))   # warmup

    def fold(kk, b):
        return jax.vmap(lambda x: jax.random.fold_in(x, 100 + b))(kk)

    trace, chain_steps_per_sec, windows = run_trace_windows(
        vblock, states, keys, fold, t_measure, c,
        min_trace_steps=t_trace)

    # trace [C, T, K]: true per-chain, per-parameter ESS series
    ess_total = sum(effective_sample_size(trace[ci, :, kk])
                    for ci in range(c) for kk in range(k))
    ess_per_chain_step = ess_total / (trace.shape[1] * c)
    ess_per_sec = ess_per_chain_step * chain_steps_per_sec

    print(json.dumps({
        "metric": f"tetra_{args.tetra}_ess_per_sec_selfing_rates_500x5k",
        "value": round(float(ess_per_sec), 3),
        "unit": "ESS/s",
        "vs_baseline": -1.0,
        "detail": {
            "chain_steps_per_sec": round(chain_steps_per_sec, 3),
            "ms_per_chain_step": round(1e3 * c / chain_steps_per_sec, 3),
            "ess_per_chain_step": round(float(ess_per_chain_step), 5),
            "chains": c, "panel": [n, l, k],
            "alleles": args.tetra_alleles, "autopoly": autopoly,
            "s_subsweeps": args.tetra_subsweeps,
            "throughput_windows": [round(w, 1) for w in windows],
        },
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small panel / short run for smoke testing")
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--tetra", choices=["auto", "allo"], default=None,
                    help="benchmark the tetraploid engine instead of the "
                         "diploid headline config")
    ap.add_argument("--tetra-alleles", type=int, default=4)
    ap.add_argument("--tetra-subsweeps", type=int, default=1,
                    help="inner S MH sweeps per tetraploid step.  "
                         "Measured r5: extra sweeps do NOT pay on the "
                         "bench panel (ESS/step 0.20 -> 0.21 at 4 sweeps "
                         "for a 27% throughput cost) — the S chain's "
                         "tau ~ 15-30 is latent-coupling, not proposal-"
                         "limited; kept as a knob")
    args = ap.parse_args()
    if args.tetra:
        return bench_tetra(args)

    import jax
    from instruct_jax.cache import enable_compile_cache
    enable_compile_cache()
    from instruct_jax.config import ModelSpec
    from instruct_jax.data.synthetic import synthetic_panel
    from instruct_jax.diagnostics import effective_sample_size
    from instruct_jax.mcmc.state import init_state
    from instruct_jax.mcmc.step import build_step_parts

    if args.quick:
        n, l, k = 200, 1000, 3
        t_measure, t_trace = 30, 150
    else:
        n, l, k = 1000, 10_000, 3
        # 2000-step trace: the Geyer ESS estimator's own noise at near-iid
        # mixing is ~1/sqrt(T); 600 steps gave round-to-round swings of
        # +-20% in ESS/step that were pure estimator variance
        t_measure, t_trace = 50, 2000

    panel = synthetic_panel(n_indv=n, n_loci=l, n_pops=k, n_alleles=2,
                            selfing_rates=np.array([0.1, 0.4, 0.8]),
                            admixture_alpha=0.1, seed=17)
    # 12 inner S-MH sweeps/step: saturates the S mixing at the
    # coupling-through-G limit for ~+10% step cost (ModelSpec.s_subsweeps;
    # 1 = the reference's schedule)
    spec = ModelSpec(mode=2, n_pops=k, s_subsweeps=12)
    step_core, add_loglik = build_step_parts(spec, panel.data)
    c = args.chains
    thinning = 10      # production default (InStruct.c:33): cal_lkh runs
    #                    on stored steps only, exactly as run_mcmc does

    def chain_block(state, key_steps):
        def body(st, i):
            st = step_core(st, jax.random.fold_in(key_steps, i))
            st = jax.lax.cond((i + 1) % thinning == 0, add_loglik,
                              lambda s: s, st)
            return st, st.rates
        return jax.lax.scan(body, state,
                            jax.numpy.arange(t_measure, dtype=jax.numpy.int32))

    vblock = jax.jit(jax.vmap(chain_block))
    keys = jax.random.split(jax.random.key(0), c)
    states = jax.vmap(lambda kk: init_state(kk, spec, panel.data))(keys)

    # warmup/compile
    states, _ = jax.block_until_ready(vblock(states, keys))

    def fold(kk, b):
        return jax.vmap(lambda x: jax.random.fold_in(x, 100 + b))(kk)

    # throughput AND the ESS trace come from the same multi-second
    # windows of the long run; two consecutive windows must agree within
    # 3% before the number is recorded (see run_trace_windows)
    trace, chain_steps_per_sec, windows = run_trace_windows(
        vblock, states, keys, fold, t_measure, c,
        min_trace_steps=t_trace)

    # trace [C, T, K]: true per-chain, per-parameter ESS series
    ess_total = 0.0
    for ci in range(c):
        for kk in range(k):
            ess_total += effective_sample_size(trace[ci, :, kk])
    ess_per_chain_step = ess_total / (trace.shape[1] * c)
    ess_per_sec = ess_per_chain_step * chain_steps_per_sec

    c_iters = read_c_baseline()
    vs = (chain_steps_per_sec / c_iters) if np.isfinite(c_iters) else -1.0

    print(json.dumps({
        "metric": "effective_samples_per_sec_selfing_rates_1000x10k",
        "value": round(float(ess_per_sec), 3),
        "unit": "ESS/s",
        "vs_baseline": round(float(vs), 2),
        "note": ("NOT COMPARABLE to BENCH_r01-r04 values: rounds 1-4 "
                 "computed ESS on chain-interleaved series (a trace-axis "
                 "bug that inflated ESS ~3.2x); this value uses the "
                 "honest per-chain estimator.  Throughput "
                 "(chain_steps_per_sec, vs_baseline) is comparable "
                 "across rounds.  See BASELINE.md round 5."),
        "detail": {
            "chain_steps_per_sec": round(chain_steps_per_sec, 3),
            "ess_per_chain_step": round(float(ess_per_chain_step), 5),
            "chains": c,
            "panel": [n, l, k],
            "c_baseline_iters_per_sec": (None if not np.isfinite(c_iters)
                                         else c_iters),
            "trace_steps": int(trace.shape[1]),
            "throughput_windows": [round(w, 1) for w in windows],
        },
    }))


if __name__ == "__main__":
    main()
