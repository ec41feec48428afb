"""The port's delta rebuild (``repro_torch.lifecycle.rebuild``) and drift
monitor (``repro_torch.lifecycle.drift``) on the CPU: the reference's
``tests/test_lifecycle.py`` rebuild cases (delta reuse, tombstone fold, the
live rebuild and swap with nothing dropped) and ``tests/test_quality_obs.py``
drift, trigger and trace-track cases on the port; the port's
``delta_build`` against the reference's on the same numpy inputs (postings
and ids bit for bit, the same stats and manifest), a port ``delta_build``
over a workdir the reference wrote (only the dirty shard streams), the drift
monitors of both packages on the same stream (equal shifts, severity and
advisories), and the q8 rebuild hook's flash tier (folded inserts are
re-ranked exactly).

The live tests wait on the scheduler's ``swapped`` event and the lanes'
completion queues with bounded timeouts, stop their threads in
``finally`` and assert ``sched.failures == []``."""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import torch_threads  # noqa: E402,F401
from repro_torch.build.pipeline import index_content_hash  # noqa: E402
from repro_torch.core.search import SearchConfig  # noqa: E402
from repro_torch.lifecycle import (  # noqa: E402
    CorpusStore, DriftMonitor, LiveFreshState, RebuildPolicy,
    RebuildScheduler, UpdateLane, VersionManager, delta_build,
    load_manifest, q8_rebuild_hook,
)
from repro_torch.obs import MetricsRegistry, TraceRecorder, \
    check_well_nested  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    BatchPolicy, DynamicBatcher, PrefetchPipeline, ServeEngine,
)
from repro_torch.storage import TieredPostings  # noqa: E402

CFG = SearchConfig(k=5, nprobe_max=8, pruning="none", use_kernel=False,
                   fused_topk=True)
BUILD = dict(cluster_len=64, eps=0.2, max_replicas=4, per_task=1000)
STAT_KEYS = ("shards_total", "shards_streamed", "shards_reused",
             "bytes_streamed", "bytes_reused", "full_stream_bytes",
             "folded_deletes")
WAIT_S = 60.0                     # bound on every event wait


@pytest.fixture(scope="module")
def cents(small_corpus):
    from repro.build.kmeans import balanced_hierarchical_kmeans

    x, _, _ = small_corpus
    c, _ = balanced_hierarchical_kmeans(x, max_cluster_size=48, iters=8)
    return np.asarray(c, np.float32)


@pytest.fixture(scope="module")
def built(small_corpus, cents, tmp_path_factory):
    x, _, _ = small_corpus
    wd = str(tmp_path_factory.mktemp("torch_lifecycle_build"))
    corpus = CorpusStore(x)
    index, stats = delta_build(corpus.view(), cents, wd, device="cpu",
                               **BUILD)
    return corpus, wd, index, stats


def _arrays(index):
    return (np.asarray(index.postings), np.asarray(index.posting_ids),
            np.asarray(index.centroids))


# -------------------------------------------------------------------------
# delta_build (tests/test_lifecycle.py's cases on the port)
# -------------------------------------------------------------------------
def test_delta_build_reuses_clean_shards(built, small_corpus, cents, rng):
    corpus, wd, index0, stats0 = built
    x, _, _ = small_corpus
    assert stats0["shards_reused"] == 0
    assert stats0["bytes_streamed"] == stats0["full_stream_bytes"]
    assert load_manifest(wd) is not None
    new = rng.normal(size=(120, x.shape[1])).astype(np.float32)
    corpus.append(new)
    index1, stats1 = delta_build(corpus.view(), cents, wd, device="cpu",
                                 **BUILD)
    assert stats1["shards_streamed"] == 1
    assert stats1["shards_reused"] == stats0["shards_total"]
    assert stats1["shards_total"] == stats0["shards_total"] + 1
    assert stats1["bytes_streamed"] * 2 <= stats1["full_stream_bytes"]
    index_full, stats_full = delta_build(corpus.view(), cents, wd,
                                         use_manifest=False, device="cpu",
                                         **BUILD)
    assert stats_full["shards_reused"] == 0
    assert index_content_hash(index1) == index_content_hash(index_full)
    assert index1.device.type == "cpu"


def test_delta_build_folds_tombstones(built, cents):
    corpus, wd, _, _ = built
    tomb = np.zeros((corpus.n,), bool)
    dead = np.asarray([0, 1, 2, 50, 51])
    tomb[dead] = True
    index, stats = delta_build(corpus.view(), cents, wd, tombstone=tomb,
                               device="cpu", **BUILD)
    assert stats["folded_deletes"] == len(dead)
    pids = index.posting_ids.numpy()
    assert not np.isin(pids[pids >= 0], dead).any()
    assert stats["shards_streamed"] == 0      # masking dirties no shard


def test_delta_build_matches_the_reference(small_corpus, cents, tmp_path):
    """Same corpus, centroids and settings through both packages: postings
    and posting ids bit for bit, the same stats and the same manifest
    (cold, then after an append and a tombstone fold)."""
    from repro.lifecycle import delta_build as ref_delta_build
    from repro.lifecycle import load_manifest as ref_load_manifest

    x, _, _ = small_corpus
    rng = np.random.default_rng(11)
    tail = rng.normal(size=(700, x.shape[1])).astype(np.float32)
    tomb = np.zeros(x.shape[0] + len(tail), bool)
    tomb[[3, 99, x.shape[0] + 5]] = True
    for i, (xs, tb) in enumerate(((x, None),
                                  (np.concatenate([x, tail]), tomb))):
        ref_i, ref_s = ref_delta_build(xs, cents, str(tmp_path / "ref"),
                                       tombstone=tb, **BUILD)
        got_i, got_s = delta_build(xs, cents, str(tmp_path / "port"),
                                   tombstone=tb, device="cpu", **BUILD)
        for a, b in zip(_arrays(got_i), _arrays(ref_i)):
            np.testing.assert_array_equal(a, b)
        assert {k: got_s[k] for k in STAT_KEYS} == \
            {k: ref_s[k] for k in STAT_KEYS}, i
        assert load_manifest(str(tmp_path / "port")) == \
            ref_load_manifest(str(tmp_path / "ref"))
        assert len(got_s["shard_stamps"]) == got_s["shards_streamed"]


@pytest.mark.parametrize("cluster_len", [8, 64])
def test_delta_build_layout_in_a_child_matches_the_reference(
        small_corpus, cents, tmp_path, cluster_len):
    """The checkpoint reads and the posting layout run in a spawned child
    (``core/postings.py``) and the payload is gathered with torch: the
    postings and ids stay bit-equal to the reference's ``delta_build`` and
    ``build_postings``, with overfull clusters cut (cluster_len 8), padded
    ones, an empty one and tombstones, and the stats carry the split."""
    from repro.core.ivf import build_postings as ref_build_postings
    from repro.lifecycle import delta_build as ref_delta_build
    from repro_torch.core.ivf import build_postings
    from repro_torch.core.postings import delta_layout

    x, _, _ = small_corpus
    cents_e = np.concatenate([cents, cents[:1] + 1e3])   # one empty cluster
    tomb = np.zeros(x.shape[0], bool)
    tomb[::7] = True
    build = {**BUILD, "cluster_len": cluster_len}
    ref_i, _ = ref_delta_build(x, cents_e, str(tmp_path / "ref"),
                               tombstone=tomb, **build)
    got_i, got_s = delta_build(x, cents_e, str(tmp_path / "port"),
                               tombstone=tomb, device="cpu", **build)
    for a, b in zip(_arrays(got_i), _arrays(ref_i)):
        assert a.tobytes() == b.tobytes()
    assert (np.asarray(got_i.posting_ids)[-1] == -1).all()
    assert got_s["assign_load_s"] >= 0 and got_s["layout_s"] >= 0
    paths = sorted(str(p) for p in (tmp_path / "port" / "shards").iterdir())
    here = delta_layout(paths, build["max_replicas"], tomb, x.shape[0],
                        cents_e.shape[0], cluster_len)
    assert np.array_equal(here["ids"], np.asarray(got_i.posting_ids))
    assign = np.concatenate([np.load(p)["assign"] for p in paths])
    assign[tomb] = -1
    for got, want in zip(build_postings(x, assign, cents_e.shape[0],
                                        cluster_len),
                         ref_build_postings(x, assign, cents_e.shape[0],
                                            cluster_len)):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def test_port_delta_build_reuses_a_reference_workdir(small_corpus, cents,
                                                     tmp_path):
    """The manifest holds the same content hashes in both packages, so a
    port build over a workdir the reference wrote streams only the shard
    an append dirtied, and builds what a full port restream builds."""
    from repro.lifecycle import delta_build as ref_delta_build

    x, _, _ = small_corpus
    wd = str(tmp_path / "shared")
    _, ref_s = ref_delta_build(x, cents, wd, **BUILD)
    grown = np.concatenate([x, np.random.default_rng(5).normal(
        size=(130, x.shape[1])).astype(np.float32)])
    got_i, got_s = delta_build(grown, cents, wd, device="cpu", **BUILD)
    assert got_s["shards_streamed"] == 1
    assert got_s["shards_reused"] == ref_s["shards_total"]
    full_i, _ = delta_build(grown, cents, str(tmp_path / "full"),
                            device="cpu", **BUILD)
    assert index_content_hash(got_i) == index_content_hash(full_i)


# -------------------------------------------------------------------------
# the live rebuild + swap through the engine
# -------------------------------------------------------------------------
def _f32_hook(index, state):
    tier = TieredPostings(index.postings.numpy(), index.posting_ids.numpy(),
                          device="cpu")
    pipe = PrefetchPipeline(index, None, CFG, tier=tier, pad_batch=8,
                            row_bucket=32, fresh_source=state.snapshot,
                            device="cpu")
    pipe.warmup(batch_sizes=(8,))
    return pipe


def test_live_rebuild_swap_zero_dropped(small_corpus, cents, tmp_path,
                                        rng):
    """Searches and updates live; the scheduler's daemon triggers on the
    delta fill, rebuilds and swaps atomically; every admitted request
    completes, the inserts stay findable across the swap, and no attempt
    failed."""
    x, q, _ = small_corpus
    wd = str(tmp_path)
    corpus = CorpusStore(x)
    index, _ = delta_build(corpus.view(), cents, wd, device="cpu", **BUILD)
    st = LiveFreshState(dim=x.shape[1], capacity=64, n_main=corpus.n,
                        device="cpu")
    lane = UpdateLane(st)
    pipe = _f32_hook(index, st)
    vm = VersionManager()
    ep0 = vm.deploy("idx", pipe, fresh=st)
    eng = ServeEngine({"idx": pipe}, DynamicBatcher(
        BatchPolicy(max_batch=16, max_wait_s=0.002, pad=8), ["idx"]),
        update_lanes={"idx": lane})
    vm.bind(eng)
    sched = RebuildScheduler(
        name="idx", corpus=corpus, centroids=cents, workdir=wd, lane=lane,
        versions=vm, make_pipeline=_f32_hook, cluster_len=64,
        policy=RebuildPolicy(delta_fill_frac=0.5, per_task=1000))
    far = rng.normal(loc=6.0, size=(40, x.shape[1])).astype(np.float32)
    want = {}
    eng.start()
    try:
        assert lane.submit_insert(far) > 0    # 40/64: over the threshold
        for i in range(32):
            eng.submit(q[i], 5, index="idx")
        assert lane.qp.wait_completions(1, timeout=WAIT_S)
        sched.start(poll_s=0.01)
        assert sched.swapped.wait(timeout=WAIT_S)
        for i in range(8):
            want[eng.submit(far[i], 5, index="idx")] = x.shape[0] + i
    finally:
        sched.stop()
        eng.stop(drain=True)
    assert sched.failures == []
    rep, = sched.reports
    assert rep.trigger == "delta_fill" and rep.tier == "f32"
    assert rep.folded_inserts == 40 and rep.shards_reused >= 4
    assert rep.bytes_streamed * 2 <= rep.full_stream_bytes
    assert rep.eid_old == ep0.eid and rep.eid_new == ep0.eid + 1
    assert ep0.finalized.wait(WAIT_S)
    comps = eng.qp.poll()
    hits = [c for c in comps
            if c.req_id in want and want[c.req_id] in c.ids.tolist()]
    assert len(hits) == 8
    assert eng.stats.completed == eng.stats.submitted
    assert eng.stats.failed == 0
    assert vm.history[0].finalized_at > 0


def test_swap_carries_ops_applied_during_the_build(small_corpus, cents,
                                                   tmp_path, rng):
    """Ops applied while the build runs (inside make_pipeline here) are
    carried into the new epoch: seq and next_id continue, the carried
    insert is a delta row of the new state, and a delete of a folded id
    stays a tombstone."""
    x, _, _ = small_corpus
    corpus = CorpusStore(x)
    index, _ = delta_build(corpus.view(), cents, str(tmp_path),
                           device="cpu", **BUILD)
    st = LiveFreshState(dim=x.shape[1], capacity=64, n_main=corpus.n,
                        device="cpu")
    lane = UpdateLane(st)
    vm = VersionManager()
    vm.deploy("idx", _f32_hook(index, st), fresh=st)
    minted = st.insert(rng.normal(size=(5, x.shape[1])).astype(np.float32))
    st.publish()
    late = rng.normal(size=(2, x.shape[1])).astype(np.float32)
    during = {}

    def hook(index, state):
        during["ids"] = st.insert(late)       # lands during the build
        st.delete(minted[:1])
        during["seq"] = st.publish()
        return _f32_hook(index, state)

    sched = RebuildScheduler(name="idx", corpus=corpus, centroids=cents,
                             workdir=str(tmp_path), lane=lane, versions=vm,
                             make_pipeline=hook, cluster_len=64,
                             policy=RebuildPolicy(per_task=1000))
    rep = sched.rebuild_and_swap(trigger="test")
    new = lane.state
    assert rep.folded_inserts == 5 and rep.carried_ops == 2
    assert new is vm.current("idx").fresh and new is not st
    assert new.fill == 2 and new.n_main == corpus.n == x.shape[0] + 5
    np.testing.assert_array_equal(new.delta_rows(0, 2)[1], during["ids"])
    assert new.next_id == st.next_id and new.seq == during["seq"] + 1
    assert new.tombstone_bits()[minted[0]]
    assert sched.failures == []


# -------------------------------------------------------------------------
# the q8 deployment's rebuild hook
# -------------------------------------------------------------------------
def _q8_case(small_corpus, cents, tmp_path, rng, flash_vectors=None):
    x, _, _ = small_corpus
    corpus = CorpusStore(x)
    index, _ = delta_build(corpus.view(), cents, str(tmp_path / "wd"),
                           device="cpu", **BUILD)
    st = LiveFreshState(dim=x.shape[1], capacity=64, n_main=corpus.n,
                        device="cpu")
    lane = UpdateLane(st)
    hook = q8_rebuild_hook(corpus, None, CFG, flash_dir=str(tmp_path),
                           warm_sizes=(8,), device="cpu", pad_batch=8,
                           row_bucket=32)
    if flash_vectors is not None:
        # the fault the hook guards against: the new epoch's flash tier
        # keeps the old corpus, so the folded ids lie past its rows
        stale = types.SimpleNamespace(view=lambda: flash_vectors)
        hook = q8_rebuild_hook(stale, None, CFG, flash_dir=str(tmp_path),
                               name="stale", warm_sizes=(8,), device="cpu",
                               pad_batch=8, row_bucket=32)
    vm = VersionManager()
    vm.deploy("idx", hook(index, st), fresh=st)
    far = rng.normal(loc=6.0, size=(8, x.shape[1])).astype(np.float32)
    minted = st.insert(far)
    st.publish()
    sched = RebuildScheduler(name="idx", corpus=corpus, centroids=cents,
                             workdir=str(tmp_path / "wd"), lane=lane,
                             versions=vm, make_pipeline=hook,
                             cluster_len=64,
                             policy=RebuildPolicy(per_task=1000))
    rep = sched.rebuild_and_swap(trigger="test")
    assert sched.failures == []
    pipe = vm.current("idx").pipeline
    queries = far + np.float32(0.01)
    try:
        out = pipe.serve_batch(queries, CFG.k)
    finally:
        for ep in (vm.current("idx"),):
            ep.pipeline.close()
            ep.pipeline.flash.release()
    exact = np.sum((queries - far) ** 2, axis=-1)
    return rep, pipe, out, minted, exact, x


def test_q8_rebuild_hook_reranks_folded_inserts_exactly(small_corpus, cents,
                                                        tmp_path, rng):
    rep, pipe, out, minted, exact, x = _q8_case(small_corpus, cents,
                                                tmp_path, rng)
    assert rep.tier == "q8" and rep.folded_inserts == len(minted)
    assert pipe.flash.n == x.shape[0] + len(minted)
    np.testing.assert_array_equal(out.ids[:, 0], minted)
    np.testing.assert_array_equal(out.dists[:, 0], exact)
    # the folded ids are main ids now: no delta row is left to merge
    assert pipe.fresh_source().fill == 0


def test_q8_rebuild_with_a_stale_flash_tier_skips_the_exact_rerank(
        small_corpus, cents, tmp_path, rng):
    """The control: a flash tier built from the old corpus leaves the
    folded ids at their q8 distances."""
    x, _, _ = small_corpus
    rep, pipe, out, minted, exact, _ = _q8_case(
        small_corpus, cents, tmp_path, rng, flash_vectors=x)
    assert pipe.flash.n == x.shape[0] and (minted >= pipe.flash.n).all()
    assert not np.array_equal(out.dists[:, 0], exact)


# -------------------------------------------------------------------------
# drift monitor (tests/test_quality_obs.py's cases on the port)
# -------------------------------------------------------------------------
def _drift_monitor(trace=None, cls=DriftMonitor, metrics=None, **kw):
    cents2 = np.array([[0.0, 0.0], [10.0, 10.0]], np.float32)
    return cls(cents2, metrics=metrics or MetricsRegistry(), trace=trace,
               shift_threshold=0.6, min_inserts=32, **kw)


def test_isotropic_inserts_do_not_advise():
    dm = _drift_monitor()
    v = np.random.default_rng(0).normal(0.0, 1.0, (200, 2)).astype(
        np.float32)
    dm.observe(np.concatenate([v, -v]))
    assert dm.advisory() is None
    assert dm.shifts().max() < 0.2
    assert dm.summary()["clusters_drifted"] == 0


def test_one_sided_pileup_advises_once_and_resets():
    tr = TraceRecorder()
    dm = _drift_monitor(trace=tr)
    v = (np.array([2.0, 0.0]) + np.random.default_rng(1).normal(
        0, 0.05, (64, 2))).astype(np.float32)
    dm.observe(v)
    assert dm.shifts()[0] > 0.9
    reason = dm.advisory()
    assert reason is not None and reason.startswith("drift:")
    dm.advisory()
    assert [e[1] for e in tr.snapshot()].count("rebuild_advisory") == 1
    assert dm.advisories == 1
    assert dm.summary()["top"][0]["cluster"] == 0
    dm.reset()
    assert dm.advisory() is None


def test_nearest_centroid_fallback_matches_explicit_cids():
    dm1, dm2 = _drift_monitor(), _drift_monitor()
    v = (np.array([10.0, 10.0]) + np.array([[1.0, 0.0]] * 40)).astype(
        np.float32)
    dm1.observe(v)
    dm2.observe(v, cids=np.ones(40, np.int64))
    np.testing.assert_allclose(dm1.shifts(), dm2.shifts())
    assert dm1.shifts()[1] > 0.9 and dm1.shifts()[0] == 0.0


def test_drift_severity_weighs_shift_by_assign_mass():
    dm = _drift_monitor()
    v0 = (np.array([2.0, 0.0]) + np.zeros((40, 2))).astype(np.float32)
    v1 = (np.array([10.0, 12.0]) + np.zeros((120, 2))).astype(np.float32)
    dm.observe(v0)
    dm.observe(v1)
    s, sev = dm.shifts(), dm.severity()
    assert s[0] > 0.9 and s[1] > 0.9
    np.testing.assert_allclose(sev, s * np.array([40, 120]) / 160.0)
    assert sev[1] > sev[0]
    assert [t["cluster"] for t in dm.summary()["top"]] == [1, 0]
    dm3 = _drift_monitor()
    dm3.observe((np.array([2.0, 0.0]) + np.zeros((64, 2))).astype(np.float32))
    dm3.observe((np.array([10.0, 12.0]) +
                 np.zeros((64, 2))).astype(np.float32))
    sev3 = dm3.severity()
    assert sev3[0] == sev3[1]
    assert [t["cluster"] for t in dm3.summary()["top"]] == [0, 1]


def test_drift_monitor_matches_the_reference():
    """One seeded stream (isotropic, then piling up on one side of a
    centroid, nearest-centroid and explicit cids, a reset in the middle)
    through both monitors: shifts, severity, advisories, instants, gauges
    and summaries equal exactly."""
    from repro.lifecycle import DriftMonitor as RefDrift
    from repro.obs import MetricsRegistry as RefMetrics
    from repro.obs import TraceRecorder as RefTrace

    rng = np.random.default_rng(21)
    cents8 = rng.normal(size=(8, 6)).astype(np.float32) * 4
    trs = (TraceRecorder(), RefTrace())
    mets = (MetricsRegistry(), RefMetrics())
    mons = [cls(cents8, metrics=m, trace=t, shift_threshold=0.5,
                min_inserts=16, max_drifted=2)
            for cls, m, t in zip((DriftMonitor, RefDrift), mets, trs)]
    for step in range(12):
        c = step % 8
        spread = 1.0 if step < 5 else 0.1
        v = (cents8[c] + (step >= 5) * 1.5 + spread * rng.normal(
            size=(24, 6))).astype(np.float32)
        cids = None if step % 3 else np.full(24, c, np.int64)
        outs = []
        for m in mons:
            m.observe(v, cids)
            outs.append((m.shifts(), m.severity(), m.advisory(),
                         m.advisories, m.summary()))
        (s0, v0, a0, n0, d0), (s1, v1, a1, n1, d1) = outs
        np.testing.assert_array_equal(s0, s1)
        np.testing.assert_array_equal(v0, v1)
        assert (a0, n0) == (a1, n1)
        assert json.dumps(d0) == json.dumps(d1)
        if step == 8:
            for m in mons:
                m.reset()
    assert mons[0].advisories >= 1
    names = [[e[1] for e in t.snapshot()] for t in trs]
    assert names[0] == names[1]
    for g in ("drift.max_shift", "drift.clusters_drifted", "drift.observed"):
        assert mets[0].gauge(g).value() == mets[1].gauge(g).value()


def test_scheduler_due_surfaces_drift_advisory():
    dm = _drift_monitor()
    lane = types.SimpleNamespace(
        state=types.SimpleNamespace(fill_frac=0.0, tombstone_frac=0.0),
        stats=types.SimpleNamespace(rejected_full=0))
    sched = RebuildScheduler(
        name="t", corpus=None, centroids=dm.centroids, workdir="",
        lane=lane, versions=None, make_pipeline=None, cluster_len=8,
        policy=RebuildPolicy(min_interval_s=0.0), clock=lambda: 100.0,
        drift=dm)
    assert sched.due() is None
    dm.observe((np.array([2.0, 0.0]) + np.zeros((64, 2))).astype(np.float32))
    assert sched.due() == "drift:1"
    lane.state.fill_frac = 1.0
    assert sched.due() == "delta_fill"
    lane.state.fill_frac, lane.state.tombstone_frac = 0.0, 0.5
    assert sched.due() == "tombstones"


def test_lifecycle_rebuild_trace_track():
    tr = TraceRecorder()
    obs = types.SimpleNamespace(trace=tr, tracing=True)
    rep = types.SimpleNamespace(
        trigger="drift:1", folded_inserts=4, mode="delta", eid_old=0,
        eid_new=1, t_snapshot=1.0, t_built=2.0, t_swapped=3.0,
        carried_ops=0, shards_streamed=2, shards_reused=6, io_cut_x=4.0,
        tier="q8")
    bstats = {"shard_stamps": [
        {"shard": 0, "rows": 10, "bytes": 640, "load_start": 1.1,
         "assign_done": 1.4, "resumed": False},
        {"shard": 1, "rows": 10, "bytes": 640, "load_start": 1.2,
         "assign_done": 1.5, "resumed": False},
        {"shard": 2, "rows": 0, "bytes": 0, "load_start": 0.0,
         "assign_done": 0.0, "resumed": True}]}
    sched = object.__new__(RebuildScheduler)
    sched.obs = obs
    sched.name = "t"
    sched._emit_rebuild_trace(rep, bstats, 0.5)
    te = tr.export()["traceEvents"]
    assert check_well_nested(te) == []
    tracks = {e["tid"]: e["args"]["name"] for e in te if e["ph"] == "M"}
    assert {"snapshot", "build", "swap"} <= {e["name"] for e in te
                                             if e["ph"] == "X"}
    assert all(tracks[e["tid"]] == "lifecycle" for e in te if e["ph"] == "X")
    swaps = [e for e in te if e["ph"] == "i" and e["name"] == "epoch_swap"]
    assert len(swaps) == 1 and swaps[0]["args"]["eid_new"] == 1
    assert swaps[0]["args"]["tier"] == "q8"
    streams = [e for e in te if e["ph"] in ("b", "e")
               and e["name"] == "shard_stream"]
    assert len(streams) == 4
    assert not any("shard2" in str(e.get("id")) for e in streams)
