"""The port's serving runtime against the JAX package's on the CPU: seeded
traffic traces, micro-batch formation under one virtual clock, and the
ServeEngine over the port's pipeline against the reference engine over the
JAX pipeline on one index (carried across as numpy arrays), driven with
``step(now=...)`` as ``tests/test_runtime.py`` drives the reference; plus
the pipeline pieces the engine reads (stage spans, latency percentiles,
the re-rank round size and quality stamps)."""
import collections
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402,F401

from _torch_port import assert_candidates_match, torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402

CFG = dict(k=5, nprobe_max=8, pruning="none", use_kernel=False,
           fused_topk=True)


# -------------------------------------------------------------------------
# loadgen
# -------------------------------------------------------------------------
def _traces(lg):
    tenants = [lg.TenantSpec("a", 40.0, topk_lo=10, topk_hi=50,
                             deadline_s=0.05, n_queries=256),
               lg.TenantSpec("b", 15.0, topk_lo=10, topk_hi=50,
                             n_queries=64)]
    return {
        "poisson": lg.poisson_trace(300.0, 1.0, seed=3, deadline_s=0.02,
                                    n_queries=64),
        "bursty": lg.bursty_trace(50.0, 500.0, 0.2, 0.3, 1.0, seed=4),
        "locality": lg.locality_skewed_trace(200.0, 1.0, 512, seed=5),
        "hot": lg.hot_cluster_trace(200.0, 1.0, 512, seed=6),
        "shard": lg.shard_skewed_trace(200.0, 1.0, 512, [1, 5, 9], seed=7),
        "drift": lg.drifting_trace(200.0, 1.0, 512, seed=8),
        "tenants": lg.multi_tenant_trace(tenants, 2.0, seed=9),
        "updates": lg.update_trace(30.0, 10.0, 1.0, seed=10, batch=4),
        "merged": lg.merge_timelines(
            lg.poisson_trace(50.0, 1.0, seed=1),
            lg.update_trace(20.0, 5.0, 1.0, seed=2)),
    }


@pytest.mark.parametrize("name", ["poisson", "bursty", "locality", "hot",
                                  "shard", "drift", "tenants", "updates",
                                  "merged"])
def test_loadgen_traces_bit_equal_to_reference(name):
    import repro.runtime.loadgen as jlg
    import repro_torch.runtime.loadgen as tlg

    want, got = _traces(jlg)[name], _traces(tlg)[name]
    assert len(got) == len(want) > 0
    assert [type(a).__name__ for a in got] == \
        [type(a).__name__ for a in want]
    assert [dataclasses.astuple(a) for a in got] == \
        [dataclasses.astuple(a) for a in want]


# -------------------------------------------------------------------------
# batcher
# -------------------------------------------------------------------------
def _formations(pkg_engine, pkg_batcher, grouping, backlog=False):
    """Requests with admission routes and deadlines fed to one batcher on a
    virtual clock; returns every formation decision.  ``backlog``: bursts of
    150 arrivals at one instant over 20,000 clusters, 16 probes each, the
    batch 32 and a cap on the union's growth (the pools of an engine that
    fell behind)."""
    rng = np.random.default_rng(21)
    batch, n_clusters, n_probe, n_req = (32, 20_000, 16, 600) if backlog \
        else (8, 40, 6, 120)
    policy = pkg_batcher.BatchPolicy(
        max_batch=batch, max_wait_s=0.004, pad=4, shed="degrade",
        degrade_nprobe=2, init_query_s=1e-3, ewma=0.0, overhead_s=1e-3,
        grouping=grouping, union_growth_cap=40 if backlog else 0)
    b = pkg_batcher.DynamicBatcher(policy, ["a", "b"])
    source = object()
    log = []
    for i in range(n_req):
        now = (i // 150) * 0.003 if backlog else i * 0.0007
        cids = rng.integers(0, n_clusters, size=n_probe).astype(np.int32)
        req = pkg_engine.SearchRequest(
            req_id=i, index="ab"[i % 5 == 0], query=np.zeros(4, np.float32),
            topk=10, deadline=None if i % 3 else now + 0.006, arrival=now,
            route=pkg_engine.make_route_plan(
                cids, int(rng.integers(2, n_probe + 1)), source))
        shed = b.add(req, now)
        if shed is not None:
            log.append(("admit-shed", shed.req_id, shed.reason))
        if backlog and i % 150 != 149:
            continue                   # the burst lands before a formation
        while True:
            mb, sheds = b.form(now)
            log += [("shed", c.req_id, c.reason) for c in sheds]
            if mb is None:
                break
            log.append((mb.index, [r.req_id for r in mb.requests],
                        mb.degraded.tolist(), mb.nprobe_cap.tolist(),
                        sorted(mb.probe_union or ())))
            b.observe(len(mb.requests), 2e-3)
    while b.pending():
        mb, sheds = b.form(1.0, force=True)
        log += [("shed", c.req_id, c.reason) for c in sheds]
        if mb is not None:
            log.append((mb.index, [r.req_id for r in mb.requests],
                        mb.degraded.tolist(), mb.nprobe_cap.tolist(),
                        sorted(mb.probe_union or ())))
    return log, dataclasses.asdict(b.stats)


@pytest.mark.parametrize("grouping,backlog", [
    ("fifo", False), ("locality", False), ("locality", True)],
    ids=["fifo", "locality", "locality-backlog"])
def test_batcher_forms_the_same_microbatches(grouping, backlog):
    import repro.runtime.batcher as jb
    import repro.runtime.engine as je
    import repro_torch.runtime.batcher as tb
    import repro_torch.runtime.engine as te

    want = _formations(je, jb, grouping, backlog)
    got = _formations(te, tb, grouping, backlog)
    assert got == want
    log, stats = got
    assert stats["batches"] > 5
    assert any(e[0] == "shed" for e in log) or stats["degraded"] > 0
    if grouping == "locality":
        assert stats["locality_batches"] > 0


# -------------------------------------------------------------------------
# engine over the pipelines
# -------------------------------------------------------------------------
def _engines(small_index, n_indexes, policy_kw, clock):
    """(reference engine over JAX pipelines, port engine over CPU port
    pipelines) on the same f32 streamed index."""
    from repro.core.search import SearchConfig as JCfg
    from repro.runtime import BatchPolicy as JPolicy
    from repro.runtime import DynamicBatcher as JBatcher
    from repro.runtime import PrefetchPipeline as JPipe
    from repro.runtime import ServeEngine as JEngine
    from repro.storage import TieredPostings as JTier
    from repro_torch.core.search import SearchConfig
    from repro_torch.runtime import BatchPolicy, DynamicBatcher, \
        PrefetchPipeline, ServeEngine
    from repro_torch.storage import TieredPostings

    post = np.asarray(small_index.postings)
    pids = np.asarray(small_index.posting_ids)
    tindex = convert.ivf_index(np.asarray(small_index.centroids), post, pids,
                               device="cpu")
    names = [f"idx{i}" for i in range(n_indexes)]
    jp = {n: JPipe(small_index, None, JCfg(**CFG), tier=JTier(post, pids),
                   pad_batch=8, row_bucket=32) for n in names}
    tp = {n: PrefetchPipeline(tindex, None, SearchConfig(**CFG),
                              tier=TieredPostings(post, pids, device="cpu"),
                              pad_batch=8, row_bucket=32, device="cpu")
          for n in names}
    jeng = JEngine(jp, JBatcher(JPolicy(**policy_kw), names), clock=clock)
    teng = ServeEngine(tp, DynamicBatcher(BatchPolicy(**policy_kw), names),
                       clock=clock)
    return jeng, teng


def _replay(eng, q, trace, vt):
    comps = []
    for arr in trace:
        vt[0] = arr.t
        eng.submit(q[arr.qrow % 64], 5, index="idx0",
                   deadline_s=arr.deadline_s)
        eng.step(now=arr.t, force=False)
        comps += eng.qp.poll()
    vt[0] = trace[-1].t + 1.0
    while eng.step(now=vt[0], force=True):
        pass
    return comps + eng.qp.poll()


def _same_completions(got, want):
    assert [(c.req_id, c.index, c.status, c.reason, c.nprobe)
            for c in got] == \
        [(c.req_id, c.index, c.status, c.reason, c.nprobe) for c in want]
    rows = [i for i, c in enumerate(want) if c.ids is not None]
    assert all((got[i].ids is None) == (want[i].ids is None)
               for i in range(len(want)))
    if rows:
        assert_candidates_match(
            np.stack([got[i].dists for i in rows]),
            np.stack([got[i].ids for i in rows]),
            np.stack([np.asarray(want[i].dists) for i in rows]),
            np.stack([np.asarray(want[i].ids) for i in rows]), tol=1e-4)


def test_engine_deadline_shedding_matches_reference(small_index,
                                                    small_corpus):
    """The deadline case of tests/test_runtime.py: saturating arrivals
    with deadlines tighter than a full batch, ewma 0 so every decision is a
    function of the seeded trace; both engines shed, degrade and answer
    the same requests with the same nprobe and ids."""
    from repro.runtime import poisson_trace

    _, q, _ = small_corpus
    q = q.astype(np.float32)
    policy = dict(max_batch=16, max_wait_s=0.005, pad=8, shed="degrade",
                  degrade_nprobe=2, init_query_s=2e-3, ewma=0.0,
                  overhead_s=1e-3)
    trace = poisson_trace(2000.0, 0.15, seed=11, deadline_s=0.012)
    vt = [0.0]
    jeng, teng = _engines(small_index, 1, policy, lambda: vt[0])
    want = _replay(jeng, q, trace, vt)
    vt[0] = 0.0
    got = _replay(teng, q, trace, vt)
    _same_completions(got, want)
    statuses = {c.status for c in got}
    assert {"shed", "degraded", "ok"} <= statuses
    assert all(0 < c.nprobe <= 2 for c in got if c.status == "degraded")
    assert dataclasses.asdict(teng.stats)["shed"] == jeng.stats.shed
    assert teng.stats.batches == jeng.stats.batches
    for p in teng.pipelines.values():
        p.close()


def test_engine_fifo_and_fairness_match_reference(small_index,
                                                  small_corpus):
    """Two tenants, best-effort, locality grouping on admission routes:
    the same completion stream (order, status, nprobe, ids up to ties)."""
    _, q, _ = small_corpus
    q = q.astype(np.float32)
    policy = dict(max_batch=16, max_wait_s=0.001, pad=8)
    jeng, teng = _engines(small_index, 2, policy, lambda: 0.0)
    out = []
    for eng in (jeng, teng):
        with pytest.raises(KeyError):
            eng.submit(q[0], 5, index="no-such-index")
        for i in range(48):
            assert eng.submit(q[i % 64], 5, index=f"idx{i % 2}") >= 0
        while eng.step(now=1.0):
            pass
        out.append(eng.qp.poll())
    want, got = out
    assert len(got) == 48
    _same_completions(got, want)
    for name in ("idx0", "idx1"):
        seq = [c.req_id for c in got if c.index == name]
        assert seq == sorted(seq)
    for p in teng.pipelines.values():
        p.close()


def test_engine_poller_thread_serves_and_drains(small_index, small_corpus):
    """The real poller thread with a depth-2 window over the port's CPU
    pipeline: every submission completes, the window went two deep, and
    stop(drain=True) leaves nothing behind."""
    from repro_torch.runtime import inflight_depth

    _, q, _ = small_corpus
    q = q.astype(np.float32)
    _, teng = _engines(small_index, 2, dict(max_batch=8, max_wait_s=0.002,
                                            pad=8), time.monotonic)
    teng.depth = 2
    times = []
    orig = teng._complete_batch

    def spy(mb, result, done, epoch=None):
        times.append(result.times)
        orig(mb, result, done, epoch=epoch)

    teng._complete_batch = spy
    teng.start()
    try:
        n = sum(teng.submit(q[i % 64], 5, index=f"idx{i % 2}") >= 0
                for i in range(80))
        assert teng.qp.wait_completions(n, timeout=60.0)
    finally:
        teng.stop(drain=True)
    comps = teng.qp.poll()
    assert len(comps) == n == 80
    assert {c.status for c in comps} == {"ok"}
    st = teng.stats
    assert st.submitted == st.completed and st.failed == 0
    assert inflight_depth(times) >= 1
    for p in teng.pipelines.values():
        p.close()


def test_engine_records_sq_peak_and_drain_gaps(small_index, small_corpus):
    """The engine's own view of its poller, on a virtual clock: the SQ's
    peak length (the most submissions one drain took), the longest gap
    between two drains, and the bounded drain log (off by default)."""
    _, q, _ = small_corpus
    q = q.astype(np.float32)
    _, teng = _engines(small_index, 1, dict(max_batch=8, max_wait_s=0.002,
                                            pad=8), lambda: 0.0)
    assert teng.drain_log is None
    teng.drain_log = collections.deque(maxlen=2)
    for i in range(5):
        teng.submit(q[i], 5, index="idx0")
    teng.step(now=1.0)
    for i in range(2):
        teng.submit(q[i], 5, index="idx0")
    teng.step(now=1.25)
    teng.step(now=2.0)
    st = teng.stats
    assert (st.sq_peak, st.drain_gap_max_s) == (5, 0.75)
    assert list(teng.drain_log) == [(1.25, 2), (2.0, 0)]
    assert st.completed == 7
    for p in teng.pipelines.values():
        p.close()


# -------------------------------------------------------------------------
# pipeline pieces the engine reads
# -------------------------------------------------------------------------
def test_stage_spans_and_latency_percentiles_equal_reference():
    from repro.runtime.pipeline import StageTimes as JT
    from repro.runtime.pipeline import latency_percentiles as jlat
    from repro.runtime.pipeline import stage_spans as jspans
    from repro_torch.runtime.pipeline import StageTimes, latency_percentiles, \
        stage_spans

    stamps = dict(plan_start=1.0, plan_end=1.5, gather_start=1.5,
                  gather_end=2.0, stream_end=2.0, scan_dispatch=2.1,
                  scan_done=3.0, rerank_start=3.0, rerank_end=3.4)
    assert stage_spans(StageTimes(**stamps)) == jspans(JT(**stamps))
    assert [n for n, _, _ in stage_spans(StageTimes(**stamps))] == \
        ["plan", "gather", "scan", "rerank"]
    lat = list(np.random.default_rng(1).lognormal(-3, 0.5, 300))
    assert latency_percentiles(lat) == jlat(lat)
    assert latency_percentiles([]) == jlat([])


@pytest.fixture(scope="module")
def q8_pipe_factory(small_index, small_corpus, tmp_path_factory):
    from repro_torch.core.search import SearchConfig
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    x, _, _ = small_corpus
    tindex = convert.ivf_index(np.asarray(small_index.centroids),
                               np.asarray(small_index.postings),
                               np.asarray(small_index.posting_ids),
                               device="cpu")
    root = tmp_path_factory.mktemp("q8pipes")

    def make(tag, **kw):
        return make_quantized_pipeline(
            tindex, None, SearchConfig(k=10, nprobe_max=8, pruning="none"),
            vectors=x, flash_path=str(root / f"{tag}.f32"), device="cpu",
            **kw)
    return make


def test_rerank_stamps_round_size_and_quality(q8_pipe_factory, small_corpus):
    from repro_torch.runtime import RerankConfig

    _, q, _ = small_corpus
    batch = (q[:16].astype(np.float32), np.full(16, 10, np.int32))
    pipe = q8_pipe_factory("full", rerank=RerankConfig(round_size=8,
                                                       stable_rounds=50))
    try:
        a = pipe.serve_batch(*batch)
    finally:
        pipe.close()
    assert a.times.rerank_rounds > 2 and a.quality is not None
    assert a.quality.shape == (16,)
    assert ((a.quality >= 0) & (a.quality <= 1)).all()
    assert a.times.rerank_round_size == 8
    assert (a.fresh_seq, a.partial, a.shards) == (-1, None, None)
