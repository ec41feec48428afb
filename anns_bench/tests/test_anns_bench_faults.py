"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU (the program's plain versions, a tiny cell), with one fault
planted where the answer or the index is produced."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from anns_bench import faults, harness


def _run(workload, seconds=1.0, seed=2 ** 33 + 5):
    res = harness.run_cell(tiny_cell(workload), [], seed, seconds, False,
                           device="cpu")
    return res["correct"], res["check"], res["run"]


@pytest.mark.parametrize("workload", ["sift1m-q8.bulk",
                                      "gist1m-f32res.bulk"])
def test_sound_run_is_correct(workload):
    ok, shown, run = _run(workload)
    assert ok, shown
    assert run.ok.all() and np.isfinite(run.done).all()


def _break_harvest(monkeypatch, fault):
    from repro_torch.runtime.pipeline import PrefetchPipeline

    orig = PrefetchPipeline.harvest
    last = {}

    def harvest(self, infl):
        res = orig(self, infl)
        ids = res.ids.copy()
        b = len(ids)
        if fault == "altered":
            ids[:, 0] = (ids[:, 0] + 1) % 1000
        elif fault == "half":
            h = b // 2
            ids[h:2 * h] = ids[:h]
        elif fault == "unchanged":
            prev = last.get("ids")
            last["ids"] = res.ids.copy()
            if prev is not None:
                m = min(len(prev), b)
                ids[:m] = prev[:m]
        res.ids = ids
        return res

    monkeypatch.setattr(PrefetchPipeline, "harvest", harvest)


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_serving_fault_is_not_correct(monkeypatch, fault):
    _break_harvest(monkeypatch, fault)
    ok, shown, _ = _run("sift1m-q8.bulk")
    assert not ok, shown
    assert shown["dist_gap"][0] > shown["dist_gap"][1]


def _break_build(monkeypatch, fault):
    from anns_bench import system

    orig = system.build
    first = {}

    def build(x, cfg, workdir, train_q, dev):
        if fault == "half":
            x = x[: len(x) // 2]
        index, llsp, report = orig(x, cfg, workdir, train_q, dev)
        if fault == "altered":
            index.postings[0, 0, 0] += 1.0
        if fault == "unchanged":
            index = first.setdefault("index", index)
        return index, llsp, report

    monkeypatch.setattr(system, "build", build)


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_build_fault_is_not_correct(monkeypatch, fault):
    _break_build(monkeypatch, fault)
    ok, shown, _ = _run("sift1m-q8.build", seconds=0.5)
    assert not ok, shown


def test_llsp_serving_a_level_lower_is_not_correct():
    with faults.planted("llsp_level"):
        ok, shown, _ = _run("sift1m-q8.bulk")
    assert not ok, shown
    assert shown["nprobe_flips"][0] > shown["nprobe_flips"][1]


def test_untrained_llsp_is_not_correct():
    with faults.planted("llsp_untrained"):
        ok, shown, _ = _run("sift1m-q8.build", seconds=0.5)
    assert not ok, shown
    assert shown["llsp_unfit"][0] > shown["llsp_unfit"][1]


def test_the_reference_runs_without_tf32(monkeypatch):
    """A program that turns TF32 on leaves the reference in float32."""
    from anns_bench import system

    orig = system.build

    def build(*a, **kw):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        return orig(*a, **kw)

    monkeypatch.setattr(system, "build", build)
    seen = []
    monkeypatch.setattr(harness.check, "build_numbers",
                        _spy(harness.check.build_numbers, seen))
    ok, shown, _ = _run("sift1m-q8.build", seconds=0.5)
    assert ok, shown
    assert seen and not any(seen)


def _spy(fn, seen):
    def wrapped(*a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest")
        return fn(*a, **kw)
    return wrapped


def test_a_kept_index_serves_as_the_built_one(tmp_path):
    """The second run of a checkout resumes the index the first kept."""
    runs = [harness.run_cell(tiny_cell("sift1m-q8.bulk"), [], 2 ** 33 + 7,
                             1.0, False, device="cpu", cache=str(tmp_path))
            for _ in range(2)]
    assert [r["run"].info["index"] for r in runs] == ["built", "kept"]
    assert all(r["correct"] for r in runs), [r["check"] for r in runs]


def test_build_kept_resumes_the_same_index(tmp_path):
    from anns_bench import datagen, system

    cell = tiny_cell("sift1m-q8.bulk")
    cfg, d = cell.config, cell.config["dataset"]
    gen = cfg["assumed"]["generator"]
    x = datagen.corpus(d["n"], d["dim"], gen, 0, "cpu").numpy()
    train = datagen.queries(cfg["llsp"]["train_queries"], d["dim"], gen, 0,
                            "cpu", "train").numpy()
    keep = str(tmp_path / "kept")
    dev = torch.device("cpu")
    out = [system.build_kept(x, cfg, keep, train, dev) for _ in range(2)]
    assert [o[3] for o in out] == [False, True]
    assert "stage1" in out[1][2].resumed_stages
    assert "stage2" in out[1][2].resumed_stages
    (i0, l0, *_), (i1, l1, *_) = out
    for f in ("centroids", "postings", "posting_ids"):
        assert torch.equal(getattr(i0, f), getattr(i1, f)), f
    t0, t1 = system.llsp_trees(l0), system.llsp_trees(l1)
    for e in ("router", "pruners"):
        for f in t0[e]:
            assert torch.equal(t0[e][f], t1[e][f]), (e, f)
    assert torch.equal(t0["levels"], t1["levels"])
