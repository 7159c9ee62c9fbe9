"""Measure the single-core reference binary on the north-star panel
(1000 individuals x 10k loci, K=3, mode 2) and print per-iteration cost.

The reference publishes no numbers (BASELINE.md); this records the measured
baseline that bench.py's `vs_baseline` is computed against.  Run on an
otherwise idle machine:  python scripts/measure_c_baseline.py
"""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

import numpy as np

from _refbinary import build_reference
from instruct_jax.data.loader import write_panel
from instruct_jax.data.synthetic import synthetic_panel

N, L, K = 1000, 10_000, 3


def run_iters(exe, datafile, out, u, b):
    t0 = time.time()
    subprocess.run(
        [exe, "-d", str(datafile), "-o", str(out), "-N", str(N),
         "-L", str(L), "-K", str(K), "-v", "2", "-u", str(u), "-b", str(b),
         "-t", "1", "-c", "1", "-pi", "0", "-g", "0", "-r", "5",
         "-j", "5", "-s", "1", "2", "3"],
        check=True, capture_output=True, timeout=36000)
    return time.time() - t0


def main():
    exe = build_reference()
    work = Path("/tmp/c_baseline")
    work.mkdir(exist_ok=True)
    datafile = work / "panel_1000x10k.txt"
    if not datafile.exists():
        print("generating panel...", flush=True)
        panel = synthetic_panel(n_indv=N, n_loci=L, n_pops=K, n_alleles=2,
                                selfing_rates=np.array([0.1, 0.4, 0.8]),
                                admixture_alpha=0.1, seed=17)
        write_panel(panel, str(datafile))
    print("timing short run (setup + 12 iters)...", flush=True)
    t_short = run_iters(exe, datafile, work / "o1.txt", 12, 6)
    print(f"  {t_short:.1f}s", flush=True)
    print("timing long run (setup + 112 iters)...", flush=True)
    t_long = run_iters(exe, datafile, work / "o2.txt", 112, 6)
    print(f"  {t_long:.1f}s", flush=True)
    per_iter = (t_long - t_short) / 100.0
    print(f"C reference: {per_iter:.3f} s/iter "
          f"({1.0 / per_iter:.3f} iters/s), setup ~"
          f"{t_short - 12 * per_iter:.1f}s")


if __name__ == "__main__":
    main()
