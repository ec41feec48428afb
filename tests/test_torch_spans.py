"""The port's sub-stage stamps and the trace spans made from them, on the
CPU: a served q8 batch's spans inside its stage spans (whether or not a
sampled request rides it), a build's span tree against its report, the
flash re-rank's stamps taken from each round's own read, and nothing
recorded with tracing off."""
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.obs import Observability, check_well_nested  # noqa: E402

BUILD = dict(max_cluster_size=48, cluster_len=64, coarse_per_task=800,
             n_workers=2)
EPS = 1e-9


@pytest.fixture(scope="module")
def q8_pipe(small_index, small_corpus, tmp_path_factory):
    """make(tag, **kw): the port's q8 pipeline with the flash re-rank over
    the shared small index, on the CPU."""
    from repro_torch.core.search import SearchConfig
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    x, _, _ = small_corpus
    tindex = convert.ivf_index(np.asarray(small_index.centroids),
                               np.asarray(small_index.postings),
                               np.asarray(small_index.posting_ids),
                               device="cpu")
    root = tmp_path_factory.mktemp("span_pipes")

    def make(tag, **kw):
        return make_quantized_pipeline(
            tindex, None, SearchConfig(k=10, nprobe_max=8, pruning="none",
                                       use_kernel=False),
            vectors=x, flash_path=str(root / f"{tag}.f32"), device="cpu",
            **kw)
    return make


def _serve(pipe, q, obs, n=48):
    """``n`` queries through a ServeEngine over ``pipe`` with ``obs``,
    FIFO batches planned at formation, stepped on a virtual clock; returns
    the engine."""
    from repro_torch.runtime import BatchPolicy, DynamicBatcher, ServeEngine

    eng = ServeEngine({"q8": pipe}, DynamicBatcher(
        BatchPolicy(max_batch=16, max_wait_s=0.001, pad=8, grouping="fifo"),
        ["q8"]),
        clock=lambda: 0.0, obs=obs)
    for i in range(n):
        assert eng.submit(q[i % len(q)].astype(np.float32), 10,
                          index="q8") >= 0
    while eng.step(now=1.0):
        pass
    assert len(eng.qp.poll()) == n
    return eng


def _xspans(obs):
    return [e for e in obs.trace.snapshot() if e[0] == "X"]


def _inside(child, parent):
    return parent[3] - EPS <= child[3] and child[4] <= parent[4] + EPS \
        and child[5] == parent[5]


@pytest.mark.parametrize("rate", [1.0, 1e-6])
def test_served_batch_spans_nest_inside_their_stages(q8_pipe, small_corpus,
                                                     rate):
    """Every batch's gather, plan and re-rank children lie inside their
    stage on the batch's lane, the gather's children cover it, and the
    export nests; at a sample rate that samples no request the batches
    keep every span (with no trace ids)."""
    from repro_torch.runtime.pipeline import RerankConfig

    _, q, _ = small_corpus
    pipe = q8_pipe(f"serve{rate}", rerank=RerankConfig(round_size=8))
    obs = Observability(rate)
    try:
        eng = _serve(pipe, q, obs)
    finally:
        pipe.close()
    spans = _xspans(obs)
    batches = [s for s in spans if s[1] == "batch"]
    assert len(batches) == eng.stats.batches >= 3
    if rate < 1.0:
        assert all(s[2] == 0 and s[6]["trace_ids"] == [] for s in batches)
        assert not [e for e in obs.trace.snapshot() if e[0] != "X"]
    for name in ("plan.wait", "gather.union", "gather.alloc", "gather.take",
                 "rerank.score", "rerank.read_wait"):
        kids = [s for s in spans if s[1] == name]
        assert len(kids) == len(batches), name
        parent = name.split(".")[0]
        assert all(any(_inside(k, p) for p in spans if p[1] == parent)
                   for k in kids), name
    assert not [s for s in spans if s[1] == "scan.device"]   # CPU: no events
    for g in (s for s in spans if s[1] == "gather"):
        kids = [s for s in spans if s[1].startswith("gather.")
                and _inside(s, g)]
        assert len(kids) == 3
        assert sum(s[4] - s[3] for s in kids) >= 0.95 * (g[4] - g[3])
    take = [s for s in spans if s[1] == "gather.take"]
    assert all(s[6]["cpu_s"] > 0.0 for s in take)
    union = [s for s in spans if s[1] == "gather.union"]
    assert all(s[6]["clusters"] > 0 and s[6]["bytes"] > 0 for s in union)
    assert check_well_nested(obs.trace.export()["traceEvents"]) == []


def test_stage_child_spans_from_stamps():
    """The children come from the stamps alone: the re-rank's summed read
    wait ends the re-rank, the scan's device time starts where its events
    place it on the host clock and is held inside the scan's window,
    unstamped children drop out."""
    from repro_torch.runtime.pipeline import StageTimes, stage_child_spans

    t = StageTimes(plan_start=1.0, plan_wait_start=1.2, plan_wait_end=1.4,
                   plan_end=1.5, gather_start=1.5, union_end=1.6,
                   alloc_end=1.8, gather_end=2.0, gather_cpu_s=0.3,
                   stream_end=2.1, scan_dispatch=2.2, scan_done=3.0,
                   scan_device_ms=500.0, scan_device_start=2.25,
                   rerank_start=3.0, rerank_end=3.4,
                   rerank_read_wait_s=0.1, union_clusters=7, union_bytes=70)
    got = {n: (a, b, args) for n, a, b, args in stage_child_spans(t)}
    assert got == {
        "plan.wait": (1.2, 1.4, None),
        "gather.union": (1.5, 1.6, {"clusters": 7, "bytes": 70}),
        "gather.alloc": (1.6, 1.8, None),
        "gather.take": (1.8, 2.0, {"cpu_s": 0.3}),
        "scan.device": (2.25, pytest.approx(2.75), {"ms": 500.0}),
        "rerank.score": (3.0, pytest.approx(3.3), None),
        "rerank.read_wait": (pytest.approx(3.3), 3.4, None)}
    t.scan_device_ms = 5000.0
    t.rerank_read_wait_s = 0.0
    got = {n: (a, b) for n, a, b, _ in stage_child_spans(t)}
    assert got["scan.device"] == (2.25, 3.0)
    assert got["rerank.score"] == (3.0, 3.4) and "rerank.read_wait" not in got
    t.scan_device_start = 2.1
    got = {n: (a, b) for n, a, b, _ in stage_child_spans(t)}
    assert got["scan.device"] == (2.2, 3.0)
    assert stage_child_spans(StageTimes()) == []


class _SlowFirstRows:
    """A flash tier's rows whose first read takes 0.2 s and the others
    0.01 s, inside the read's own stamps."""

    def __init__(self, rows):
        self.rows, self.calls, self.lock = rows, 0, threading.Lock()

    def __getitem__(self, idx):
        with self.lock:
            first = self.calls == 0
            self.calls += 1
        time.sleep(0.2 if first else 0.01)
        return self.rows[idx]


def test_rerank_stamps_come_from_each_rounds_own_read(q8_pipe, small_corpus):
    """Round 0's read is slower than round 1's and runs beside it (two
    read lanes), so round 1's read ends first: each round still adds its
    own read to ``rerank_io_s``, and the time blocked on the reads is
    stamped."""
    from repro_torch.runtime.pipeline import RerankConfig

    _, q, _ = small_corpus
    pipe = q8_pipe("race", rerank=RerankConfig(round_size=8,
                                               stable_rounds=50))
    pipe._reranker.shutdown()
    pipe._reranker = ThreadPoolExecutor(max_workers=2)
    pipe.flash._mm = _SlowFirstRows(pipe.flash._mm)
    try:
        res = pipe.serve_batch(q[:16].astype(np.float32), 10)
    finally:
        pipe.close()
    t, evs = res.times, pipe.flash.stats.events
    assert t.rerank_rounds == len(evs) >= 3
    assert evs[0].end - evs[0].start < 0.1 <= evs[1].end - evs[1].start
    assert t.rerank_io_s == pytest.approx(
        sum(e.end - e.start for e in evs), rel=1e-9)
    assert 0.15 < t.rerank_read_wait_s <= t.rerank_end - t.rerank_start


@pytest.fixture(scope="module")
def traced_build(small_corpus, tmp_path_factory):
    from repro_torch.build.pipeline import BuildConfig, build_index
    from repro_torch.core.llsp import LLSPConfig

    x, q, topk = small_corpus
    obs = Observability(1.0)
    cfg = BuildConfig(**BUILD, llsp=LLSPConfig(
        levels=(8, 16, 32), n_ratio_features=8, n_trees=10, max_depth=3))
    _, _, report = build_index(
        x, cfg, str(tmp_path_factory.mktemp("traced_build")), queries=q,
        query_topk=np.minimum(topk, 20), device="cpu", obs=obs)
    return report, obs


def test_build_span_tree_matches_its_report(traced_build):
    """The build's stage spans last as long as its stage seconds, stage 1
    has a K23 span a lockstep step, stage 2 four spans a shard, stage 3
    its labelling and fit, and the export nests."""
    report, obs = traced_build
    spans = _xspans(obs)
    by = {}
    for s in spans:
        by.setdefault(s[1], []).append(s)
    for k in ("stage1", "stage2", "stage3"):
        (s,) = by[f"build.{k}"]
        assert abs((s[4] - s[3]) - report.stage_seconds[k]) < 1e-3
        assert _inside(s, by["build"][0])
    steps = sum(st.steps for st in report.stage1_split)
    assert len(by["stage1.k23"]) == steps > 0
    assert sum(s[6]["subproblems"] for s in by["stage1.k23"]) == \
        sum(st.subproblems for st in report.stage1_split)
    assert len(by["stage1.split"]) == len(report.stage1_split) == 2
    for split in by["stage1.split"]:     # its steps cover it, end to end
        kids = [s for s in spans if s[1] != "stage1.split"
                and _inside(s, split)]
        assert {s[1] for s in kids} == {"stage1.upload", "stage1.host",
                                        "stage1.k23", "stage1.means"}
        assert sum(s[4] - s[3] for s in kids) == pytest.approx(
            split[4] - split[3], abs=1e-3)
    assert sum(s[4] - s[3] for s in by["stage1.host"]) == pytest.approx(
        sum(st.host_s for st in report.stage1_split), abs=1e-3)
    n_shards = len(report.shard_stamps)
    for name in ("shard.load", "shard.h2d", "shard.assign", "shard.write"):
        assert len(by[name]) == n_shards >= 2, name
    assert sum(s[6]["rows"] for s in by["shard.assign"]) == 4000
    for name, parent in (("stage1.size_bound", "build.stage1"),
                         ("stage1.save", "build.stage1"),
                         ("stage2.postings", "build.stage2"),
                         ("shard.assign", "build.stage2"),
                         ("llsp.label", "build.stage3"),
                         ("llsp.fit", "build.stage3")):
        assert all(_inside(s, by[parent][0]) for s in by[name]), name
    assert check_well_nested(obs.trace.export()["traceEvents"]) == []


def test_split_spans_come_from_the_splitters_stamps():
    """The lockstep splitter stamps each call and step on its thread: the
    spans made from them tile the call, one K23 span a step, the host
    spans summing to ``host_s``."""
    from repro_torch.build.kmeans import SplitStats, \
        balanced_hierarchical_kmeans_many

    rng = np.random.default_rng(0)
    st = SplitStats()
    balanced_hierarchical_kmeans_many(
        [rng.standard_normal((600, 8)).astype(np.float32),
         rng.standard_normal((300, 8)).astype(np.float32)], [1, 2], 40,
        iters=2, device="cpu", stats=st)
    sp = st.spans()
    assert st.track == threading.current_thread().name
    assert {s[3] for s in sp} == {st.track}
    by = {}
    for s in sp:
        by.setdefault(s[0], []).append(s)
    (call,) = by["stage1.split"]
    assert len(by["stage1.k23"]) == st.steps > 0
    assert sum(s[4]["subproblems"] for s in by["stage1.k23"]) == \
        st.subproblems
    assert sum(s[2] - s[1] for s in by["stage1.host"]) == pytest.approx(
        st.host_s, abs=1e-6)
    kids = sorted((s for s in sp if s[0] != "stage1.split"),
                  key=lambda s: s[1])
    assert kids[0][0] == "stage1.upload" and kids[-1][0] == "stage1.means"
    assert call[1] == kids[0][1] and call[2] == kids[-1][2]
    assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))
    assert sum(s[2] - s[1] for s in kids) == pytest.approx(
        call[2] - call[1], abs=1e-3)


def test_tracing_off_records_nothing(q8_pipe, small_corpus, tmp_path):
    """``Observability.off()``: a served window and a build leave the
    recorder empty."""
    from repro_torch.build.pipeline import BuildConfig, build_index

    x, q, _ = small_corpus
    obs = Observability.off()
    pipe = q8_pipe("off")
    try:
        _serve(pipe, q, obs, n=24)
    finally:
        pipe.close()
    build_index(x[:1600], BuildConfig(**BUILD), str(tmp_path), device="cpu",
                obs=obs)
    assert obs.trace.snapshot() == [] and obs.trace.dropped_events == 0
