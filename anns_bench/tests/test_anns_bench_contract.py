"""BENCHMARK.json against the benchmark's contract, and a cell added as
data files alone found by the harness."""
from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import ROOT, bench

from anns_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _metrics(b):
    return b["end_to_end"] + b["per_layer"]


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == KEYS
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert b["command"][1].startswith(b["paths"][0] + "/")
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)


def test_names_and_units_use_allowed_characters():
    b = bench()
    names = [m["name"] for m in _metrics(b)] + \
        [w["name"] for w in b["workloads"]] + \
        [c["name"] for c in b["configs"]] + \
        [w["traffic"] for w in b["workloads"]] + \
        [w["config"] for w in b["workloads"]] + \
        [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in _metrics(b):
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in (_metrics(b), b["workloads"], b["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for text in [w["why"] for w in b["workloads"]] + \
            [c["why"] for c in b["configs"]] + \
            [c["source"] for c in b["configs"]] + \
            [m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries_and_bounds():
    b = bench()
    names = [m["name"] for m in b["end_to_end"]]
    assert "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in names
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["source"] == "device_trace"


def test_every_cell_reports_what_its_layer_metrics_move():
    b = bench()
    for w in b["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(b, w["name"], False)}
        layers = harness.cell_metrics(b, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in b["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in
                                  harness.cell_metrics(b, w, False)}


def test_every_name_has_its_file():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in b["workloads"]:
        harness.load_cell(b, w["name"])
    for m in _metrics(b):
        assert callable(harness.reader(m["name"]))


def test_a_cell_added_as_data_files_is_found(tmp_path, monkeypatch):
    here = tmp_path / "anns_bench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(harness.HERE / d, here / d)
    (here / "traffic" / "online.json").write_text(json.dumps(
        {"kind": "open", "trace": "poisson_trace",
         "args": {"rate_qps": 1000.0, "topk": [10, 10]},
         "max_batch": 4096, "max_wait_s": 0.005, "shed": "none",
         "grouping": "fifo", "depth": 2, "sq_depth": 65536,
         "warm_sizes": [4096], "warm_blocks": 1, "callers": 1,
         "block": 4096}))
    (here / "limits" / "sift1m-q8.online.json").write_text(
        json.dumps({"dist_gap": 0.001, "failed": 0}))
    (here / "metrics" / "p99_ms.py").write_text(
        "def read(run):\n    return None\n")
    monkeypatch.setattr(harness, "HERE", here)
    b = bench()
    b["workloads"].append({"name": "sift1m-q8.online", "config": "sift1m-q8",
                           "traffic": "online", "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "p99_ms", "unit": "ms",
                            "better": "lower", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["sift1m-q8.online"]})
    cell = harness.load_cell(b, "sift1m-q8.online")
    assert cell.traffic["kind"] == "open" and cell.limits["dist_gap"] == 0.001
    names = {m["name"] for m in harness.cell_metrics(b, cell.name, False)}
    assert names == {"p99_ms", "setup_s"}
    assert harness.reader("p99_ms")(None) is None


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell(bench(), "no-such.cell")
