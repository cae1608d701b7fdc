"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or pbrt_tpu (the port's name begins with the JAX package's, so names are
compared whole), and a reference that loads nothing of the renderer."""
import json
import os
import subprocess
import sys

from perfbench.bench.loader import ROOT

_RUN = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from perfbench.bench import harness
sys.path.insert(0, {tests!r})
from conftest import tiny
names = set()
for cell in ("sphere135k.final1024", "sphere135k.preview256"):
    r = harness.run_cell(cell, 5, 0.1, cell.endswith("preview256"), device="cpu",
                         overrides=tiny(cell))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF = r"""
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.pathtrace
from perfbench.bench import check, roofline, stats, trace, traffic
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(src):
    out = subprocess.run([sys.executable, "-c", src.format(
        root=ROOT, tests=os.path.join(ROOT, "perfbench", "tests"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    names = _top_level(_RUN)
    assert "pbrt_tpu_torch" in names and "perfbench" in names
    assert not names & {"jax", "jaxlib", "flax", "pbrt_tpu"}


def test_the_reference_loads_nothing_of_the_renderer():
    names = _top_level(_REF)
    assert not names & {"jax", "jaxlib", "flax", "pbrt_tpu", "pbrt_tpu_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from perfbench.bench import harness

    monkeypatch.setitem(sys.modules, "pbrt_tpu_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
