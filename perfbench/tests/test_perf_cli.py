"""The command: without a card it fails and prints no result; on a card
(gpu marker) one short run of each cell prints a correct result line."""
import json
import os
import subprocess
import sys

import pytest

from perfbench.bench.loader import ROOT


def _run(cell, extra_env=None, timeout=600):
    env = dict(os.environ, **(extra_env or {}))
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env)


def test_without_a_card_it_fails_and_prints_no_result():
    out = _run("sphere135k.preview256", {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_an_unknown_cell_is_refused():
    out = _run("no.such.cell")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["sphere135k.final1024", "sphere135k.preview256"])
def test_a_cell_runs_on_the_card(cell, card):
    out = _run(cell, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "check"
