"""Golden-diff of report STRUCTURE vs the compiled reference binary: every
section header the reference writes (printinfo, InStruct.c:450-531;
chain_stat, result_analysis.c:34-414) must appear in our report, in the
same order, so downstream parsers of InStruct output work unchanged."""

import re
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

from instruct_jax.config import ModelSpec, Schedule
from instruct_jax.data.loader import read_data, write_panel
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.mcmc.driver import run_mcmc
from instruct_jax.report import write_report

from _refbinary import build_reference, run_reference

gcc_missing = shutil.which("gcc") is None

# Structural lines of the mode-2 report (banner echo + per-chain sections);
# matched as prefixes against both outputs.
HEADERS = [
    "Run parameters:",
    "    Chain Number=",
    "    MCMC Iterations Number=",
    "    Burn-in=",
    "    Thinning=",
    "    Ploid=",
    "    Population size=",
    "    Number of loci=",
    "    Population number assumed=",
    "    Mode = Make inference of population structure and the selfing "
    "rates for subpopulations.",
    "The log Likelihood:",
    "    Posterior Mean =",
    "    Posterior Variance =",
    "The Deviance information criterion of this model is",
    "The Posterior distribution of Selfing Rates:",
    "The Posterior distribution of Generations:",
    "Inferred ancestry of individuals:",
    "Proportion of membership of each pre-defined population",
]


def first_positions(text, headers):
    pos = {}
    for h in headers:
        i = text.find(h)
        if i >= 0:
            pos[h] = i
    return pos


@pytest.mark.skipif(gcc_missing, reason="gcc not available")
def test_report_section_headers_match_reference(tmp_path):
    exe = build_reference()
    panel = synthetic_panel(n_indv=30, n_loci=30, n_pops=2, n_alleles=2,
                            selfing_rates=np.array([0.2, 0.7]), seed=5)
    datafile = tmp_path / "panel.txt"
    write_panel(panel, str(datafile))
    ref_out = tmp_path / "ref.txt"
    run_reference(exe, datafile, ref_out, panel.n_indv, panel.n_loci,
                  2, 2, 400, 200, 5, chains=1)
    ref_text = Path(ref_out).read_text()

    panel2 = read_data(str(datafile), ploid=2, log=open("/dev/null", "w"))
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(n_iter=400, burnin=200, thinning=5, n_chains=1,
                     ckrep=20, nstep_check_empty_cluster=10)
    res = run_mcmc(panel2.data, spec, sched, jax.random.key(0))
    our_out = tmp_path / "ours.txt"
    write_report(str(our_out), panel2, spec, sched, res)
    our_text = Path(our_out).read_text()

    ref_pos = first_positions(ref_text, HEADERS)
    our_pos = first_positions(our_text, HEADERS)
    # every header the binary produced must appear in our report
    missing = [h for h in ref_pos if h not in our_pos]
    assert not missing, f"headers missing from our report: {missing}"
    # and in the same relative order
    ref_order = sorted(ref_pos, key=ref_pos.get)
    our_order = sorted((h for h in ref_order), key=our_pos.get)
    assert our_order == ref_order, (ref_order, our_order)
    # table row shapes: Cluster rows under the S section look identical
    assert re.search(r"Cluster 1\t[-\d.]+\t[-\d.]+", ref_text)
    assert re.search(r"Cluster 1\t[-\d.]+\t[-\d.]+", our_text)
