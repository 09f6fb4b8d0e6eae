"""Cells, configurations, traffic mixes and metrics are found by name, and
``BENCHMARK.json`` keeps to the benchmark's contract; a cell is added as
new files alone."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench._small import small_cell

BENCH = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
        assert json.loads((harness.ROOT.parent / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        # each cell a metric names reports the end-to-end metric it moves
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = harness.Cell.find(name)
    assert cell.kind().Cell is not None
    lims = json.loads((harness.ROOT / "limits" / f"{name}.json").read_text())["limits"]
    assert lims and all(v >= 0 for v in lims.values())
    e2e, layer = cell.metrics(False), cell.metrics(True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(cell.reader(m["name"]).read)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_as_new_files(tmp_path):
    """A throwaway deployment, mix, limits and metric, added as files to a
    copy of the benchmark, run by the copy's harness; no file edited."""
    src = harness.ROOT
    root = tmp_path / "portbench"
    shutil.copytree(src, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root)
    cfg = json.loads((root / "configs" / "field-n1000.json").read_text())
    cfg.update(name="tiny-line", n_sensors=12, dim=1, radius=0.5, n_sweeps=2)
    (root / "configs" / "tiny-line.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "train-b256.json").read_text())
    mix.update(fields=2, warm_calls=1, checked_calls=1)
    (root / "traffic" / "tiny-train.json").write_text(json.dumps(mix))
    (root / "limits" / "tiny-cell.json").write_text(json.dumps({"limits": {
        "build": 0, "gram_err": 1e-4, "chol_err": 1e-4, "z_err": 1e-3, "coef_err": 1e-3}}))
    (root / "metrics" / "calls_seen.py").write_text(
        "def read(ctx):\n    return len(ctx.window['items'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-line", "source": "test", "file":
                             "portbench/configs/tiny-line.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny-line",
                               "traffic": "tiny-train", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_fields_per_s":
            m["workloads"].append("tiny-cell")
    cell = harness.Cell.find("tiny-cell", root=root, bench=bench)
    res = harness.run_cell(cell, 7, 0.1, False, torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "calls_seen", "train_fields_per_s"}
    assert res["metrics"]["calls_seen"]["value"] == res["attempted"]
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited


def test_small_cells_differ_only_in_scale():
    for name in CELLS:
        big, small = harness.Cell.find(name), small_cell(name)
        assert big.traffic["kind"] == small.traffic["kind"]
        assert big.config["dtype"] == small.config["dtype"]
