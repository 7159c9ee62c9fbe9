"""CLI end-to-end: reference-style flags drive a full run and produce the
report + convergence files."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from instruct_jax.cli import main
from instruct_jax.data.loader import write_panel
from instruct_jax.data.synthetic import synthetic_panel


@pytest.fixture()
def datafile(tmp_path):
    panel = synthetic_panel(n_indv=15, n_loci=12, n_pops=2, seed=21)
    f = tmp_path / "panel.txt"
    write_panel(panel, str(f))
    return f


def test_cli_mode2(datafile, tmp_path, capsys):
    out = tmp_path / "out.txt"
    cvg = tmp_path / "cvg.txt"
    rc = main(["-d", str(datafile), "-o", str(out), "-v", "2", "-K", "2",
               "-u", "40", "-b", "20", "-t", "2", "-c", "2", "-r", "5",
               "-j", "5", "-s", "1", "2", "3", "-cf", str(cvg),
               "--platform", "cpu"])
    assert rc == 0
    text = out.read_text()
    assert "Selfing Rates" in text
    assert "Gelman-Rubin" in text
    assert "Inferred ancestry" in text
    assert "Values of log-likelihood" in cvg.read_text()
    assert "SUCCESSFULLY FINISHED" in capsys.readouterr().out


def test_cli_infer_k(datafile, tmp_path, capsys):
    out = tmp_path / "out.txt"
    rc = main(["-d", str(datafile), "-o", str(out), "-v", "1",
               "-u", "30", "-b", "10", "-t", "2", "-c", "1", "-r", "5",
               "-j", "5", "-ik", "1", "-kv", "1", "2", "-g", "0",
               "--platform", "cpu"])
    assert rc == 0
    assert "The optimal K is" in capsys.readouterr().out


def test_cli_initfile(datafile, tmp_path):
    init = tmp_path / "init.txt"
    init.write_text(">warm_start\n0.2 0.7\n")
    out = tmp_path / "out.txt"
    rc = main(["-d", str(datafile), "-o", str(out), "-v", "2", "-K", "2",
               "-u", "30", "-b", "10", "-t", "2", "-c", "1", "-r", "5",
               "-j", "5", "-g", "0", "-i", str(init), "--platform", "cpu"])
    assert rc == 0
    assert "warm_start" in out.read_text()


@pytest.mark.parametrize("sampler", ["hmc", "svi", "smc"])
def test_cli_alternative_samplers(datafile, tmp_path, capsys, sampler):
    out = tmp_path / f"{sampler}.txt"
    rc = main(["-d", str(datafile), "-o", str(out), "-v", "2", "-K", "2",
               "-u", "60", "-b", "30", "-t", "2", "-c", "2", "-r", "5",
               "-j", "5", "-g", "0", "--sampler", sampler,
               "--platform", "cpu"])
    assert rc == 0
    text = out.read_text()
    assert "Selfing Rates" in text
    assert "Inferred ancestry" in text
