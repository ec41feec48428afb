"""The readers of the program's sub-stage stamps (``metrics/`` over
``spans.py``) on synthetic runs, and :func:`spans.idle_by_span` on
synthetic gaps and spans."""
from __future__ import annotations

import types

import numpy as np
import pytest

import conftest  # noqa: F401  (paths)

from anns_bench import harness, spans

SERVE = ("alloc_ms.q8", "take_ms.q8", "gather_cpu.q8", "rerank_read_ms.q8",
         "scan_dev_ms.bulk")
BUILD = ("stage1_host_s", "stage3_s")


def _batch(i: int):
    from repro_torch.runtime.pipeline import StageTimes

    t0 = 10.0 * (i + 1)
    return StageTimes(
        gather_start=t0, union_end=t0 + 0.01, alloc_end=t0 + 0.03,
        gather_end=t0 + 0.10, gather_cpu_s=0.05, stream_end=t0 + 0.11,
        scan_dispatch=t0 + 0.2, scan_done=t0 + 0.7,
        scan_device_ms=400.0 + 100.0 * i, rerank_start=t0 + 0.7,
        rerank_end=t0 + 0.9, rerank_read_wait_s=0.02 * (i + 1))


def _run(batches=(), builds=()):
    run = harness.Run(None, 0, 1.0, True)
    run.batches = [(t, np.zeros(1, np.int32)) for t in batches]
    run.builds = list(builds)
    return run


def _report(host_s, stage3):
    from repro_torch.build.kmeans import SplitStats
    from repro_torch.build.pipeline import BuildReport

    return BuildReport(
        n_clusters=1, replication=1.0,
        stage_seconds={"stage1": 1.0, "stage2": 1.0, "stage3": stage3},
        resumed_stages=[],
        stage1_split=[SplitStats(host_s=h) for h in host_s])


def test_serving_readers_read_the_batch_stamps():
    run = _run([_batch(0), _batch(1)])
    got = {n: harness.reader(n)(run) for n in SERVE}
    assert got == pytest.approx({
        "alloc_ms.q8": 20.0, "take_ms.q8": 70.0, "gather_cpu.q8": 50.0,
        "rerank_read_ms.q8": 30.0, "scan_dev_ms.bulk": 450.0})


def test_build_readers_read_the_report():
    run = _run(builds=[{"report": _report([1.0, 2.0], 2.5)},
                       {"report": _report([0.5, 0.5], 3.5)}])
    assert harness.reader("stage1_host_s")(run) == pytest.approx(2.0)
    assert harness.reader("stage3_s")(run) == pytest.approx(3.0)


@pytest.mark.parametrize("name", SERVE)
def test_readers_give_nothing_without_the_stamps(name):
    """A program whose StageTimes lacks the new stamps (an older checkout)
    leaves the reading out, and nothing raises."""
    old = types.SimpleNamespace(gather_start=1.0, gather_end=2.0,
                                stream_end=2.5, scan_dispatch=3.0,
                                scan_done=4.0, rerank_start=4.0,
                                rerank_end=5.0)
    assert harness.reader(name)(_run([old])) is None


def _traced(run, busy):
    run.trace = types.SimpleNamespace(intervals=busy)
    run.window = (0.0, 30.0)
    return run


def test_program_spans_are_the_programs_own_from_the_stamps():
    """Each batch's stage spans and their children on a track of its own,
    each build's tree from its report, as the program makes them."""
    from repro_torch.build.pipeline import build_spans
    from repro_torch.runtime.pipeline import stage_child_spans, stage_spans

    b0, b1 = _batch(0), _batch(1)
    rep = _report([1.0], 2.0)
    rep.stamps = {"build": (21.0, 25.0), "build.stage3": (23.0, 25.0)}
    ev = spans.program_spans(_run([b0, b1], [{"report": rep}]))
    assert all(e[0] == "X" and e[2] == 0 for e in ev)
    for i, t in enumerate((b0, b1)):
        got = sorted((e[1], e[3], e[4]) for e in ev
                     if e[5] == f"batch-{i}")
        want = sorted([*stage_spans(t),
                       *((n, a, b) for n, a, b, _ in stage_child_spans(t))])
        assert got == want and len(got) == 9
    assert sorted((e[1], e[3], e[4], e[5]) for e in ev
                  if not e[5].startswith("batch-")) == \
        sorted(sp[:4] for sp in build_spans(rep, "build"))


def test_keep_idle_split_splits_a_traced_runs_idle_time():
    """A traced run keeps the idle split by the batches' spans in its log;
    an untraced run keeps nothing."""
    run = _run([_batch(0)])
    harness.reader("take_ms.q8")(run)
    assert "idle_by_span" not in run.info
    run = _traced(_run([_batch(0)]), [(0.0, 10.0, "k"), (10.2, 30.0, "k")])
    harness.reader("take_ms.q8")(run)
    got = dict(run.info["idle_by_span"])
    assert got == pytest.approx({"gather.union": 0.01, "gather.alloc": 0.02,
                                 "gather.take": 0.07, "stream": 0.01,
                                 spans.OUTSIDE: 0.09})


def test_idle_split_and_readers_pass_over_a_program_without_the_spans(
        monkeypatch):
    """Over an older program (no span functions, no new stamps) a traced
    run's readers give nothing and keep no split, and nothing raises."""
    from repro_torch.build import pipeline as build
    from repro_torch.runtime import pipeline

    monkeypatch.delattr(pipeline, "stage_child_spans")
    monkeypatch.delattr(build, "build_spans")
    old = types.SimpleNamespace(gather_start=1.0, gather_end=2.0,
                                stream_end=2.5, scan_dispatch=3.0,
                                scan_done=4.0, rerank_start=4.0,
                                rerank_end=5.0, plan_start=0.5, plan_end=1.0)
    run = _traced(_run([old], [{"report": _report([1.0], 2.0)}]),
                  [(0.0, 0.5, "k")])
    for name in SERVE:
        assert harness.reader(name)(run) is None
    assert harness.reader("stage3_s")(run) == pytest.approx(2.0)
    assert "idle_by_span" not in run.info


def _x(name, a, b, track):
    return ("X", name, 0, a, b, track, None)


def test_idle_by_span_takes_the_deepest_covering_span():
    """Busy [0, 1] and [9, 10] of a 10 s window: the gap [1, 9] goes piece
    by piece to the deepest span covering it, a waiting span after any
    other, a leaf before a parent, and what no span covers is outside."""
    busy = [(0.0, 1.0, "k"), (9.0, 10.0, "k")]
    ev = [_x("batch", 0.5, 8.0, "lane-0"),
          _x("gather", 1.0, 4.0, "lane-0"),
          _x("gather.take", 2.0, 4.0, "lane-0"),
          _x("scan", 4.0, 8.0, "lane-0"),
          _x("scan.device", 4.0, 6.0, "lane-0"),
          _x("rerank", 6.0, 7.0, "lane-1"),
          _x("rerank.score", 6.0, 7.0, "lane-1"),
          ("i", "done:ok", 1, 5.0, 5.0, "requests", None)]
    got = dict(spans.idle_by_span(busy, ev, (0.0, 10.0)))
    assert got == pytest.approx({
        "gather": 1.0,               # [1, 2]: depth 1 under batch
        "gather.take": 2.0,          # [2, 4]: depth 2
        "scan": 2.0 + 1.0,           # [4, 6] before scan.device (waiting),
                                     # [7, 8] alone
        "rerank.score": 1.0,         # [6, 7]: a leaf, before scan
        spans.OUTSIDE: 1.0})         # [8, 9]
    assert sum(got.values()) == pytest.approx(8.0)


def test_idle_by_span_prefers_another_tracks_leaf_to_a_waiting_parent():
    """A build's stage waits on its thread while a worker thread's spans
    run: the worker's leaf takes the gap, equal parents share it."""
    busy = [(2.0, 4.0, "k")]
    ev = [_x("build.stage1", 0.0, 10.0, "main"),
          _x("stage1.size_bound", 8.0, 9.0, "main"),
          _x("stage1.split", 1.0, 7.0, "worker"),
          _x("stage1.k23", 2.0, 4.0, "worker"),
          _x("stage1.host", 4.0, 7.0, "worker")]
    got = dict(spans.idle_by_span(busy, ev, (0.0, 10.0)))
    assert got == pytest.approx({
        "build.stage1": 1.0 + 0.5 + 1.0 + 1.0,   # [0, 1], half [1, 2],
                                                 # [7, 8], [9, 10]
        "stage1.split": 0.5, "stage1.host": 3.0,
        "stage1.size_bound": 1.0})


def test_idle_by_span_clips_to_the_window_and_counts_all_idle():
    busy = [(2.0, 3.0, "k")]
    ev = [_x("build", -5.0, 20.0, "main"), _x("build.stage1", 1.0, 2.5,
                                               "main")]
    got = dict(spans.idle_by_span(busy, ev, (0.0, 4.0)))
    assert got == pytest.approx({"build": 2.0, "build.stage1": 1.0})
    assert dict(spans.idle_by_span(busy, [], (0.0, 4.0))) == \
        pytest.approx({spans.OUTSIDE: 3.0})
