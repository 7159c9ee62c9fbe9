#!/usr/bin/env python3
"""Smoke run of the Gibbs sweep on the GPU: the quickest proof that the
system starts and computes the right thing on the card.

    python chip_smoke.py                # one card, every phase
    python chip_smoke.py --four-cards   # the mesh phase only, on four cards

Run it from the root of a checkout.  One process drives the card(s).
Phases (one card):

  device   platform, card name and power limit, JAX version, flags, cache
  cli      the flagship panel (mode 2, 1000 x 10k, K=3, 4 chains,
           s_subsweeps 12) through ``instruct_jax.cli.main``: the report
           parses, every log-likelihood is finite, posterior-mean S is
           within S_TOL of the truth
  library  modes 1, 3, 4, 5 (DPM) at the flagship size, tetraploid auto
           and allo at 500 x 5k (A=4), the padded K grid; a few steps
           each, every result finite; memory of the flagship step
  kernels  each Pallas kernel against its plain XLA reference at the
           flagship (packed biallelic) and at A=4, with injected uniforms
  timing   chain-steps/s of the jitted mode-2 flagship step, 4 chains,
           XLA path against each kernel, in turns

Any failed check raises, so the script exits non-zero; the last line of
standard output is one JSON object, printed only when every phase passed.
It refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np

S_TRUTH = np.array([0.1, 0.4, 0.8])
S_TOL = 0.1            # |posterior-mean S - truth| per pop, sorted rates
Z_TIE = 1e-6           # u this close to a CDF boundary is a near-tie
LL_RTOL = 1e-5         # log-ratios / log-likelihoods, relative
LL_ATOL_ULP = 1e-6     # ... plus this times the L1 mass of the summed terms
S_RTOL = 1e-6          # S-tail rates
FLAGSHIP = dict(n_indv=1000, n_loci=10_000, n_pops=3)
TETRA = dict(n_indv=500, n_loci=5000, n_pops=3, n_alleles=4, seed=7)


def log(*a):
    print(*a, flush=True)


def card_info() -> str:
    """nvidia-smi's name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip()


def require_gpu(platform: str) -> None:
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{platform!r}); this check runs only on the card")


def flagship_panel(n_alleles=2, seed=17):
    from instruct_jax.data.synthetic import synthetic_panel
    return synthetic_panel(n_alleles=n_alleles, selfing_rates=S_TRUTH,
                           admixture_alpha=0.1, seed=seed, **FLAGSHIP)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    log("  ok:", msg)


# ---------------------------------------------------------------------------
# phase: device
# ---------------------------------------------------------------------------

def phase_device(cache_dir):
    import jax
    d = jax.devices()
    log(f"platform={d[0].platform} kind={d[0].device_kind} count={len(d)}")
    log(f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache={cache_dir}")
    log(f"card: {card_info()}")


# ---------------------------------------------------------------------------
# phase: cli
# ---------------------------------------------------------------------------

def parse_report(text):
    """Per-chain (posterior-mean log-lik, cluster S means) of a report."""
    chains = []
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if line.strip() == "The log Likelihood:":
            m = re.match(r"\s*Posterior Mean = (\S+)", lines[i + 1])
            chains.append({"ll": float(m.group(1)), "s": []})
        m = re.match(r"Cluster (\d+)\t(\S+)\t", line)
        if m and chains:
            chains[-1]["s"].append(float(m.group(2)))
    return chains


def phase_cli():
    from instruct_jax.cli import main as cli_main
    from instruct_jax.data.loader import write_panel
    panel = flagship_panel()
    with tempfile.TemporaryDirectory() as td:
        data = os.path.join(td, "panel.txt")
        out = os.path.join(td, "out.txt")
        cvg = os.path.join(td, "cvg.txt")
        write_panel(panel, data)
        t0 = time.perf_counter()
        rc = cli_main(["-d", data, "-o", out, "-v", "2", "-K", "3",
                       "-N", str(FLAGSHIP["n_indv"]),
                       "-L", str(FLAGSHIP["n_loci"]),
                       "-u", "400", "-b", "200", "-t", "10", "-c", "4",
                       "-r", "10", "-j", "10", "-s", "1", "2", "3",
                       "--s-subsweeps", "12", "-cf", cvg, "-pi", "0"])
        wall = time.perf_counter() - t0
        report = open(out).read()
        trace = open(cvg).read().split(":", 1)[1].split()
    log(f"cli: 400 iterations x 4 chains, wall {wall:.1f} s "
        f"(compile included)")
    check(rc == 0, "cli.main returned 0")
    chains = parse_report(report)
    check(len(chains) == 4 and all(len(c["s"]) == 3 for c in chains),
          "report parses: 4 chains x 3 selfing rates")
    lls = np.array([c["ll"] for c in chains] + [float(v) for v in trace])
    check(np.isfinite(lls).all(),
          f"{lls.size} log-likelihoods finite (posterior means + trace)")
    s = np.sort(np.array([c["s"] for c in chains]), axis=1)
    log(f"  posterior-mean S per chain (sorted): {s.tolist()}")
    err = np.abs(s - S_TRUTH[None]).max()
    check(err <= S_TOL, f"S within {S_TOL} of truth {S_TRUTH.tolist()} "
          f"(max error {err:.3f})")


# ---------------------------------------------------------------------------
# phase: library
# ---------------------------------------------------------------------------

def _finite_run(name, data, spec, sched, key, **kw):
    import jax
    from instruct_jax.mcmc.driver import run_mcmc
    t0 = time.perf_counter()
    res = run_mcmc(data, spec, sched, key, **kw)
    jax.block_until_ready(res.final_state)
    wall = time.perf_counter() - t0
    m = res.accum.mean
    vals = [np.asarray(m.total_ll), np.asarray(m.rates), np.asarray(m.q),
            np.asarray(res.final_state.loglik_indv)]
    check(all(np.isfinite(v).all() for v in vals),
          f"{name}: finite log-liks, rates, q (wall {wall:.1f} s, "
          f"compile included)")
    return res


def phase_library():
    import jax
    from instruct_jax.config import ModelSpec, PriorFamily, Priors, Schedule
    from instruct_jax.data.synthetic import synthetic_tetra_panel
    from instruct_jax.kselect import infer_k
    sched = Schedule(n_iter=20, burnin=10, thinning=2, n_chains=4, ckrep=5,
                     nstep_check_empty_cluster=5)
    panel = flagship_panel()
    key = jax.random.key(5)
    for mode in (1, 3, 4):
        _finite_run(f"mode {mode}", panel.data,
                    ModelSpec(mode=mode, n_pops=3), sched, key)
    _finite_run("mode 5 DPM", panel.data,
                ModelSpec(mode=5, n_pops=3,
                          priors=Priors(family=PriorFamily.DPM)),
                sched, key)
    for autopoly in (True, False):
        tp = synthetic_tetra_panel(autopoly=autopoly, **TETRA)
        _finite_run(f"tetra {'auto' if autopoly else 'allo'} 500x5k",
                    tp.data, ModelSpec(mode=2, ploid=4, n_pops=3,
                                       autopoly=autopoly), sched, key)
    t0 = time.perf_counter()
    ks = infer_k(panel.data, ModelSpec(mode=1, n_pops=1),
                 Schedule(n_iter=20, burnin=10, thinning=2, n_chains=2,
                          ckrep=5, nstep_check_empty_cluster=5),
                 key, 1, 4, grid=True)
    dics = np.concatenate([np.asarray(v).ravel() for v in ks.dic.values()])
    check(np.isfinite(dics).all() and ks.best_k in range(1, 5),
          f"padded K grid 1..4: finite DIC, best K {ks.best_k} "
          f"(wall {time.perf_counter() - t0:.1f} s)")
    flagship_memory(panel)


def _vstep(spec, data, variant="auto", steps=1, thinning=10):
    """jit(vmap over chains (scan of ``steps`` sweeps, cal_lkh on every
    ``thinning``-th)) for the mode-2 flagship, by variant: "xla" (no
    kernels), "xla+stail" (S-tail kernel, site updates on XLA), "site"
    (site-pass kernel, S tail on XLA), "full" (both kernels), "auto"
    (whatever the platform picks)."""
    import dataclasses

    import jax
    from instruct_jax.mcmc import step as st
    if variant == "xla":
        core, add_ll = st.build_step_parts(
            dataclasses.replace(spec, use_pallas=False), data)
    elif variant == "xla+stail":
        core, add_ll = st._build_xla_parts(spec, data, s_tail_kernel=True)
    elif variant == "site":
        core, add_ll = st._build_fused_parts(spec, data, s_tail_kernel=False)
    elif variant == "full":
        core, add_ll = st.build_step_parts(
            dataclasses.replace(spec, use_pallas=True), data)
    else:
        core, add_ll = st.build_step_parts(spec, data)

    def block(state, key):
        def body(s, i):
            s = core(s, jax.random.fold_in(key, i))
            s = jax.lax.cond((i + 1) % thinning == 0, add_ll, lambda x: x, s)
            return s, None
        return jax.lax.scan(body, state, jax.numpy.arange(steps))[0]
    return jax.jit(jax.vmap(block))


def _init(spec, data, chains, seed=0):
    import jax
    from instruct_jax.mcmc.state import init_state
    keys = jax.random.split(jax.random.key(seed), chains)
    return jax.vmap(lambda k: init_state(k, spec, data))(keys), keys


def flagship_memory(panel):
    import jax
    from instruct_jax.config import ModelSpec
    spec = ModelSpec(mode=2, n_pops=3, s_subsweeps=12)
    states, keys = _init(spec, panel.data, 4)
    f = _vstep(spec, panel.data, steps=10)
    compiled = f.lower(states, keys).compile()
    log(f"flagship step memory_analysis: {compiled.memory_analysis()}")
    jax.block_until_ready(compiled(states, keys))
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


# ---------------------------------------------------------------------------
# phase: kernels (on-card comparison with the XLA reference)
# ---------------------------------------------------------------------------

def _compare_site_pass(name, panel):
    import jax
    import jax.numpy as jnp
    from instruct_jax.kernels import fused_step as fs
    from instruct_jax.kernels import reference as ref
    from instruct_jax.mcmc import updates as up
    from instruct_jax.config import ModelSpec
    from instruct_jax.mcmc.state import masked_z_counts
    data = panel.data
    n, l = data.site_valid.shape
    k, a = FLAGSHIP["n_pops"], data.max_alleles
    key = jax.random.key(11)
    kf, kq, kz, kg, ku = jax.random.split(key, 5)
    freq = jax.random.dirichlet(kf, jnp.ones(a), (k, l)).astype(jnp.float32)
    freq = jnp.where(data.allele_valid[None], freq, 0.0)
    freq = freq / freq.sum(-1, keepdims=True)
    q = jax.random.dirichlet(kq, jnp.ones(k), (n,)).astype(jnp.float32)
    gen = jax.random.randint(kg, (n, 2), 1, 12)
    wg_pair = jnp.exp2(1.0 - gen.astype(jnp.float32))
    u = jax.random.uniform(ku, data.geno.shape, minval=1e-6,
                           maxval=1 - 1e-6)
    z_old = jax.random.randint(kz, data.geno.shape, 0, k, dtype=jnp.int8)

    z, qqnum, diff, zcounts = jax.block_until_ready(fs.zq_gendiff_pass(
        0, q, freq, data.geno, data.site_valid, data.hom, z_old, wg_pair,
        structure=True, u=u, bits2=data.bits2))
    with jax.default_matmul_precision("highest"):
        z_ref, gap = jax.jit(ref.z_draw)(u, q, freq, data)
        spec = ModelSpec(mode=2, n_pops=k)
        cnt_ref = jax.jit(lambda zz: up.allele_pop_counts(
            spec, data, zz, None))(z)
        qq_ref = jax.jit(lambda zz: masked_z_counts(zz, data, k))(z)
        d_ref, d_l1 = jax.jit(ref.gendiff)(freq, data, z, wg_pair)
        wg = wg_pair[:, :1]
        ll_ref, ll_l1 = jax.jit(ref.panel_loglik)(freq, data, z, wg)
    ll = fs.panel_loglik_pass(freq, q, data.geno, data.site_valid, data.hom,
                              z, wg, structure=True, bits2=data.bits2)

    zk, zr = np.asarray(z, np.int32), np.asarray(z_ref)
    miss = zk != zr
    ties = np.asarray(gap) < Z_TIE
    log(f"{name}: z mismatches {int(miss.sum())} of {zk.size}; near-tie "
        f"sites (u within {Z_TIE} of a CDF boundary) {int(ties.sum())}")
    check(not (miss & ~ties).any(),
          f"{name}: z identical except at near-ties")
    check(np.array_equal(np.asarray(zcounts), np.asarray(cnt_ref))
          and np.array_equal(np.asarray(qqnum), np.asarray(qq_ref)),
          f"{name}: allele-pop and per-individual counts exactly equal")
    for what, got, want, l1 in (("G log-ratio", diff, d_ref, d_l1),
                                ("panel log-lik", ll, ll_ref, ll_l1)):
        got, want, l1 = (np.asarray(x, np.float64) for x in (got, want, l1))
        err = np.abs(got - want)
        bound = LL_RTOL * np.abs(want) + LL_ATOL_ULP * l1
        ratio = err / np.maximum(bound, np.finfo(np.float64).tiny)
        log(f"{name}: {what} max |err| {err.max():.3e}, max err/bound "
            f"{ratio.max():.3f} (rtol {LL_RTOL} + "
            f"{LL_ATOL_ULP} x L1 mass)")
        check((err <= bound).all(), f"{name}: {what} within tolerance")


def _compare_s_tail():
    import jax
    import jax.numpy as jnp
    from instruct_jax.kernels import s_pop_pallas as sp
    n, k, sub = FLAGSHIP["n_indv"], FLAGSHIP["n_pops"], 12
    key = jax.random.key(4)
    kq, kg, kr, kd = jax.random.split(key, 4)
    q = jax.random.dirichlet(kq, jnp.full(k, 0.4), (n,)).astype(jnp.float32)
    gen = jax.random.randint(kg, (n,), 1, 9)
    rates = jax.random.uniform(kr, (k,), minval=0.05, maxval=0.95)
    draws = [jax.random.uniform(kk, (m,), minval=1e-4, maxval=1 - 1e-4)
             for kk, m in zip(jax.random.split(kd, 4),
                              (sub * k, sub * k, n, n))]
    got = sp.s_pop_tail(jnp.zeros(2, jnp.int32), q, gen, rates,
                        subsweeps=sub, delta0=0.05, gen_cap=50,
                        test_draws=draws)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda: sp.s_pop_tail_reference(
            q, gen, rates, draws, subsweeps=sub, delta0=0.05,
            gen_cap=50))()
    r_err = np.abs(np.asarray(got[0]) - np.asarray(want[0]))
    log(f"S tail: rates |err| {r_err.max():.3e}; gen proposals differ at "
        f"{int((np.asarray(got[1]) != np.asarray(want[1])).sum())} of {n}")
    check(np.allclose(got[0], want[0], rtol=S_RTOL, atol=0),
          f"S tail rates within rtol {S_RTOL}")
    check(np.array_equal(np.asarray(got[1]), np.asarray(want[1])),
          "S tail G proposals identical")
    check(np.allclose(got[2], want[2], rtol=1e-6)
          and np.allclose(got[3], want[3], rtol=1e-6),
          "S tail generation weights and log-uniforms within rtol 1e-6")


def phase_kernels():
    _compare_site_pass("flagship A=2 (packed)", flagship_panel())
    _compare_site_pass("A=4 panel (unpacked)", flagship_panel(n_alleles=4))
    _compare_s_tail()


# ---------------------------------------------------------------------------
# phase: timing (XLA vs kernels, in turns)
# ---------------------------------------------------------------------------

def phase_timing(steps=100, chains=4):
    import jax
    from instruct_jax.config import ModelSpec
    panel = flagship_panel()
    spec = ModelSpec(mode=2, n_pops=3, s_subsweeps=12)
    states, keys = _init(spec, panel.data, chains)
    fns = {}
    for v in ("xla", "xla+stail", "site", "full"):
        t0 = time.perf_counter()
        fns[v] = _vstep(spec, panel.data, v, steps=steps).lower(
            states, keys).compile()
        jax.block_until_ready(fns[v](states, keys))
        log(f"timing: {v} compile + first run {time.perf_counter() - t0:.1f}"
            f" s (set-up)")
    rates = {v: [] for v in fns}
    for v in ("xla", "xla+stail", "site", "full", "full", "site",
              "xla+stail", "xla"):
        t0 = time.perf_counter()
        jax.block_until_ready(fns[v](states, keys))
        dt = time.perf_counter() - t0
        rates[v].append(chains * steps / dt)
        log(f"timing: {v} {chains * steps / dt:.1f} chain-steps/s")
    mean = {v: float(np.mean(r)) for v, r in rates.items()}
    log(f"card: {card_info()}")
    log("timing summary (chain-steps/s, mode 2 flagship, 4 chains, "
        f"s_subsweeps 12): {json.dumps(mean)}")
    for kernel, with_, without in (("site-pass", "site", "xla"),
                                   ("site-pass", "full", "xla+stail"),
                                   ("S-tail", "xla+stail", "xla"),
                                   ("S-tail", "full", "site")):
        r = mean[with_] / mean[without]
        log(f"{kernel} kernel: {with_} / {without} = {r:.3f} -> "
            f"{'faster' if r > 1 else 'slower'} end to end")


# ---------------------------------------------------------------------------
# phase: four cards
# ---------------------------------------------------------------------------

def _s_chain_means(res):
    """Per-chain posterior-mean S, each chain's rates sorted (labels are
    arbitrary per chain)."""
    return np.sort(np.asarray(res.accum.mean.rates), axis=1)


def _mcse(per_chain):
    return per_chain.std(axis=0, ddof=1) / np.sqrt(per_chain.shape[0])


def phase_four_cards():
    import jax
    from instruct_jax.config import ModelSpec, Schedule
    from instruct_jax.data.synthetic import synthetic_tetra_panel
    from instruct_jax.mcmc.driver import run_mcmc
    from instruct_jax.parallel.mesh import make_mesh
    check(len(jax.devices()) == 4, "four devices visible")
    panel = flagship_panel()
    spec = ModelSpec(mode=2, n_pops=3, s_subsweeps=12)
    key = jax.random.key(9)

    short = Schedule(n_iter=20, burnin=10, thinning=2, n_chains=4, ckrep=5,
                     nstep_check_empty_cluster=5)
    one = run_mcmc(panel.data, spec, short, key)
    four = run_mcmc(panel.data, spec, short, key, mesh=make_mesh(4, 1))
    a, b = np.asarray(one.accum.mean.rates), np.asarray(four.accum.mean.rates)
    la, lb = (np.asarray(r.accum.mean.total_ll) for r in (one, four))
    log(f"chain-sharded (4,1): max |dS| {np.abs(a - b).max():.3e}, "
        f"max |dLL| {np.abs(la - lb).max():.3e}")
    check(np.allclose(a, b, rtol=1e-5) and np.allclose(la, lb, rtol=1e-5),
          "chain-sharded run equals the one-card run to rtol 1e-5")

    long = Schedule(n_iter=300, burnin=100, thinning=2, n_chains=4,
                    ckrep=10, nstep_check_empty_cluster=10)
    for name, data, sp in (
            ("flagship", panel.data, spec),
            ("tetra auto 500x5k", synthetic_tetra_panel(
                autopoly=True, **TETRA).data,
             ModelSpec(mode=2, ploid=4, n_pops=3))):
        r1 = _s_chain_means(run_mcmc(data, sp, long, key))
        r4 = _s_chain_means(run_mcmc(data, sp, long, key,
                                     mesh=make_mesh(1, 4)))
        d = np.abs(r1.mean(0) - r4.mean(0))
        tol = 4 * np.sqrt(_mcse(r1) ** 2 + _mcse(r4) ** 2)
        log(f"{name} loci-sharded (1,4): mean S one card "
            f"{r1.mean(0).round(4).tolist()}, four cards "
            f"{r4.mean(0).round(4).tolist()}, |d| {d.round(4).tolist()}, "
            f"4 MCSE {tol.round(4).tolist()}")
        check((d <= tol).all(), f"{name}: loci-sharded S within 4 MCSE")


PHASES = {"device": None, "cli": phase_cli, "library": phase_library,
          "kernels": phase_kernels, "timing": phase_timing}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    require_gpu(devices[0].platform)
    from instruct_jax.cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    phase_device(cache_dir)
    t_all = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        for name in args.phases.split(","):
            if PHASES[name] is None:
                continue
            t0 = time.perf_counter()
            log(f"== phase {name}")
            PHASES[name]()
            log(f"== phase {name} done in {time.perf_counter() - t0:.1f} s")
    log(f"all phases done in {time.perf_counter() - t_all:.1f} s")
    log(card_info())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
