"""Finds a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names its configuration and its traffic;
each lives in files of its own, found by name:

- perfbench/workloads/<cell>.json: the traffic (resolution, samples,
  camera motion, frame seeding, the check's sample and limits);
- the configuration's `file` (perfbench/configs/<config>.json) and its
  module perfbench/configs/<config>.py, which builds the scene through
  the renderer's API (`emit_scene`), gives the plain reference that
  checks it (`reference`) and may give its own comparison (`compare`);
- perfbench/end_to_end/<metric>.py: one reader per end-to-end metric,
  `read(window)`;
- perfbench/metrics/<metric>.py: one reader per per-layer metric,
  `read(run)`.

A cell that names a missing configuration, traffic or reader is refused
before anything runs.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class CellError(ValueError):
    """The cell cannot be run as BENCHMARK.json describes it."""


@dataclass
class Cell:
    name: str
    entry: dict               # the cell's entry of `workloads`
    traffic: dict             # perfbench/workloads/<cell>.json
    config: dict              # the configuration's file
    builder: object           # perfbench/configs/<config>.py
    end_to_end: list          # [(entry, reader module)] of the end-to-end metrics
    per_layer: list = field(default_factory=list)   # [(entry, reader module)]


def import_file(path: str, name: str):
    if not os.path.isfile(path):
        raise CellError(f"missing file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise CellError(f"missing file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with `workloads` applies to the cells it lists; one
    without, to every cell that reports the end-to-end metric it moves
    (an end-to-end metric without the key: to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def readers(metrics: list, directory: str, prefix: str) -> list:
    """-> [(entry, module)]: each metric's reader <directory>/<name>.py."""
    return [(m, import_file(os.path.join(directory, f"{m['name']}.py"),
                            f"{prefix}_{m['name'].replace('.', '_').replace('-', '_')}"))
            for m in metrics]


def load_cell(name: str, bench: dict = None, root: str = ROOT) -> Cell:
    bench = bench if bench is not None else read_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise CellError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if entry["config"] not in configs:
        raise CellError(f"cell {name!r} names the missing configuration {entry['config']!r}")
    cfg_entry = configs[entry["config"]]
    bench_dir = os.path.join(root, "perfbench")
    traffic = read_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    config = read_json(os.path.join(root, cfg_entry["file"]))
    builder = import_file(os.path.join(bench_dir, "configs", f"{entry['config']}.py"),
                          f"perfbench_config_{entry['config']}")
    e2e = readers([m for m in bench["end_to_end"] if applies(m, name, set())],
                  os.path.join(bench_dir, "end_to_end"), "perfbench_e2e")
    reported = {m["name"] for m, _ in e2e}
    per_layer = readers([m for m in bench["per_layer"] if applies(m, name, reported)],
                        os.path.join(bench_dir, "metrics"), "perfbench_metric")
    return Cell(name=name, entry=entry, traffic=traffic, config=config,
                builder=builder, end_to_end=e2e, per_layer=per_layer)
