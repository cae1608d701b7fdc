"""The loader finds a cell's files by name and refuses a cell it cannot run."""
import copy
import json
import os

import pytest

from perfbench.bench import loader


def _bench():
    with open(os.path.join(loader.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_loads_with_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = loader.load_cell(w["name"], bench)
        assert cell.traffic["config"] == w["config"] == cell.config["name"]
        assert {m["name"] for m, _ in cell.end_to_end} >= {"setup_s", "samples_per_s"}
        assert all(hasattr(r, "read") for _, r in cell.end_to_end)
        assert cell.per_layer and all(hasattr(r, "read") for _, r in cell.per_layer)
        for m, _ in cell.per_layer:
            assert m["moves"] in {e["name"] for e, _ in cell.end_to_end}


def test_metric_workloads_select_cells():
    bench = _bench()
    final = loader.load_cell("sphere135k.final1024", bench)
    preview = loader.load_cell("sphere135k.preview256", bench)
    assert "preview_frame_p90_s" not in {m["name"] for m, _ in final.end_to_end}
    assert "preview_frame_p90_s" in {m["name"] for m, _ in preview.end_to_end}


@pytest.mark.parametrize("fault", ["cell", "config", "config_file", "metric", "end_to_end",
                                   "traffic"])
def test_refuses_a_cell_with_a_missing_part(fault, tmp_path):
    bench = copy.deepcopy(_bench())
    name = bench["workloads"][0]["name"]
    root = loader.ROOT
    if fault == "cell":
        name = "no.such.cell"
    elif fault == "config":
        bench["workloads"][0]["config"] = "no_such_config"
    elif fault == "config_file":
        bench["configs"][0]["file"] = "perfbench/configs/no_such_config.json"
    elif fault == "metric":
        bench["per_layer"].append({"name": "no_such_metric", "unit": "s", "better": "lower",
                                   "source": "host_clock", "layer": "device",
                                   "moves": "setup_s", "workloads": [name]})
    elif fault == "end_to_end":
        bench["end_to_end"].append({"name": "no_such_metric", "unit": "s", "better": "lower",
                                    "bound": 0.25, "source": "host_clock"})
    else:
        # a checkout without the cell's traffic file
        for d in ("configs", "metrics", "workloads"):
            os.makedirs(tmp_path / "perfbench" / d)
        for f in os.listdir(os.path.join(root, "perfbench", "configs")):
            (tmp_path / "perfbench" / "configs" / f).write_bytes(
                open(os.path.join(root, "perfbench", "configs", f), "rb").read())
        root = str(tmp_path)
    with pytest.raises(loader.CellError):
        loader.load_cell(name, bench, root=root)


def test_refuses_a_cell_on_more_cards_than_one():
    from perfbench.bench import harness

    bench = copy.deepcopy(_bench())
    bench["workloads"][0]["chips"] = 4
    with pytest.raises(loader.CellError):
        harness.run_cell(bench["workloads"][0]["name"], 1, 0.1, False, device="cpu",
                         bench=bench)
