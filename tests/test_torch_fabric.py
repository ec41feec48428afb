"""The port's sharded serving fabric (``repro_torch.distributed.fabric``) on
the CPU: ``tests/test_fabric.py``'s cases on the port (S = 1 bit-equal to
S = 2, 4, 8, replication, the live SQ/CQ path, p2c, the kill, stall,
corrupt and unreplicated drills, the engine kill drill), the kill drill's
trace integrity (``tests/test_obs.py``) and the coverage stamps
(``tests/test_quality_obs.py``); and the port's ``scan_sync`` against the
reference's on the converted index, ids equal and distances bit-equal on
every query whose probe plan is the same in both packages.

The live tests never sleep for a result: they wait on the fabric's events
and the engine's drain with bounded timeouts, stop their threads in
``finally``, keep hedging off (``hedge_after_s=30``) except in the hedge
test, declare a shard dead only after ``MISS_TICKS`` silent heartbeat
ticks, and assert outcomes, never durations."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.core.distance import recall_at_k  # noqa: E402
from repro_torch.core.search import SearchConfig  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    FaultEvent, FaultInjector, ShardedFabric,
)
from repro_torch.distributed.fabric import HEDGE_MIN_SEEN  # noqa: E402
from repro_torch.obs import Observability, check_well_nested  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    BatchPolicy, DynamicBatcher, ServeEngine, shard_skewed_trace,
)

CFG = SearchConfig(k=5, nprobe_max=8, pruning="none", use_kernel=False,
                   fused_topk=True)
NO_HEDGE = 30.0                   # hedging off: only the failure paths act
MISS_TICKS = 25                   # heartbeat ticks without a beat before a
                                  # shard is declared dead: a healthy worker
                                  # starved of the GIL on a loaded runner
                                  # must not read as a corpse


@pytest.fixture(scope="module")
def port_index(small_index):
    return convert.ivf_index(np.asarray(small_index.centroids),
                             np.asarray(small_index.postings),
                             np.asarray(small_index.posting_ids),
                             device="cpu")


@pytest.fixture(scope="module")
def queries(small_corpus):
    _, q, _ = small_corpus
    return q.astype(np.float32)


def _fabric(index, n_shards, **kw):
    kw.setdefault("hedge_after_s", NO_HEDGE)
    kw.setdefault("miss_threshold", MISS_TICKS)
    return ShardedFabric(index, None, CFG, n_shards=n_shards, device="cpu",
                         **kw)


@pytest.fixture(scope="module")
def ref_result(port_index, queries):
    """Single-shard fabric scan: the bit-equality reference."""
    fab = _fabric(port_index, 1)
    try:
        return fab.scan_sync(queries, CFG.k)
    finally:
        fab.close()


def _replicated(index, n_shards, **kw):
    """Fabric with EVERY cluster R=2-replicated (no cluster is lost when
    any single shard dies)."""
    return _fabric(index, n_shards,
                   hot_clusters=np.arange(index.n_clusters), **kw)


def _live_batch(fab, queries, deadline=None):
    """One batch through the stage protocol (worker threads, SQ/CQ,
    hedging, failure detection)."""
    plan = fab.plan(queries, CFG.k, deadline=deadline)
    return fab.harvest(fab.dispatch(fab.prefetch(plan)))


# -------------------------------------------------------------------------
# cross-shard merge parity
# -------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_scan_sync_bit_equal_across_shard_counts(port_index, queries,
                                                 ref_result, n_shards):
    fab = _fabric(port_index, n_shards)
    try:
        out = fab.scan_sync(queries, CFG.k)
    finally:
        fab.close()
    np.testing.assert_array_equal(out.ids, ref_result.ids)
    np.testing.assert_array_equal(out.dists, ref_result.dists)
    assert not out.partial.any()


def test_replication_does_not_change_results(port_index, queries,
                                             ref_result):
    fab = _replicated(port_index, 4)
    try:
        out = fab.scan_sync(queries, CFG.k)
    finally:
        fab.close()
    np.testing.assert_array_equal(out.ids, ref_result.ids)
    np.testing.assert_array_equal(out.dists, ref_result.dists)


def test_scan_sync_matches_the_reference_fabric(small_index, port_index,
                                                queries):
    """The port's scan_sync against the reference's on the same index
    (pruning "none"): on every query whose probe plan agrees, ids equal and
    distances bit-equal (the shard scans are the same numpy).  A plan may
    differ only where two centroids tie at the nprobe boundary; such
    queries are counted, each checked to be a near-tie, and stated."""
    from repro.distributed import ShardedFabric as RefFabric
    from repro.core.search import SearchConfig as RefConfig

    rcfg = RefConfig(k=5, nprobe_max=8, pruning="none", use_kernel=False,
                     fused_topk=True)
    for n_shards in (1, 4):
        ref = RefFabric(small_index, None, rcfg, n_shards=n_shards)
        port = _fabric(port_index, n_shards)
        try:
            r = ref.scan_sync(queries, rcfg.k)
            p = port.scan_sync(queries, CFG.k)
            r_plan = ref.plan(queries, rcfg.k)
            p_plan = port.plan(queries, CFG.k)
        finally:
            port.close()
        b = len(queries)
        r_sets = [set(np.asarray(r_plan.cids)[i][np.asarray(
            r_plan.pmask)[i]].tolist()) for i in range(b)]
        p_sets = [set(p_plan.cids[i][p_plan.pmask[i]].tolist())
                  for i in range(b)]
        same = np.array([a == c for a, c in zip(r_sets, p_sets)])
        cents = np.asarray(small_index.centroids, np.float64)
        for i in np.nonzero(~same)[0]:
            d = ((cents - queries[i].astype(np.float64)) ** 2).sum(axis=1)
            swapped = sorted(r_sets[i] ^ p_sets[i])
            bound = np.sort(d)[CFG.nprobe_max - 1]
            assert np.allclose(d[swapped], bound, rtol=1e-5), (i, swapped)
        n_diff = int((~same).sum())
        print(f"S={n_shards}: {n_diff} of {b} plans differ at a centroid "
              f"near-tie")
        assert n_diff <= max(1, b // 50)
        np.testing.assert_array_equal(p.ids[same], np.asarray(r.ids)[same])
        np.testing.assert_array_equal(p.dists[same],
                                      np.asarray(r.dists)[same])


def test_live_queue_path_matches_sync(port_index, queries, ref_result):
    """The threaded SQ/CQ path (p2c routing, worker scans, CQ merge) is
    bit-equal to the deterministic sync path."""
    fab = _replicated(port_index, 4)
    fab.start()
    try:
        out = _live_batch(fab, queries[:32])
    finally:
        fab.close()
    np.testing.assert_array_equal(out.ids, ref_result.ids[:32])
    np.testing.assert_array_equal(out.dists, ref_result.dists[:32])
    assert not out.partial.any()
    assert fab.stats.replies > 0 and fab.stats.timeouts == 0


def test_a_shard_busy_scanning_keeps_beating(port_index, queries):
    """A task whose scan spans more heartbeat ticks than the miss window
    does not read as a dead shard: the worker beats before each cluster
    block.  The clock ticks once a block here (as on a slow host), so
    without those beats the shard would be declared dead after three."""
    fab = _fabric(port_index, 1, miss_threshold=3)
    try:
        node = fab.nodes[0]
        plan = fab.plan(queries[:32], CFG.k)
        state = fab.prefetch(plan)             # not started: stays queued
        task, = node.qp.pop_submissions()
        assert task.cids.size > 3 * fab.hb.miss_threshold

        def tick_then_beat():
            fab.hb.tick()
            node._alive()

        node.scan(task, beat=tick_then_beat)
        assert fab.hb.clock == task.cids.size
        assert fab.hb.failed().size == 0
        node.scan(task, beat=fab.hb.tick)      # the same scan, no beats
        assert fab.hb.failed().tolist() == [0]
        fab._drop_outstanding(task.task_id)
        assert not state.complete
    finally:
        fab.close()


# -------------------------------------------------------------------------
# replica routing
# -------------------------------------------------------------------------
def test_p2c_routes_to_less_loaded_replica(port_index):
    fab = _replicated(port_index, 2)
    try:
        wanted = np.arange(port_index.n_clusters, dtype=np.int64)
        fab._out_per_shard[0] = 1000
        by_shard, lost = fab._p2c_assign(wanted)
        assert not lost and list(by_shard) == [1]
        fab._out_per_shard[0] = 0
        by_shard, _ = fab._p2c_assign(wanted)
    finally:
        fab.close()
    sizes = {s: len(c) for s, c in by_shard.items()}
    assert set(sizes) == {0, 1}
    assert abs(sizes[0] - sizes[1]) <= 1       # load feedback alternates


# -------------------------------------------------------------------------
# fault drills (live workers)
# -------------------------------------------------------------------------
def test_kill_failover_is_zero_loss_when_replicated(port_index, queries,
                                                    ref_result):
    """Silently kill a shard between two live batches: the heartbeat
    monitor finds it, plan_failover reroutes its clusters, its epoch
    retires (tier released), and the next batch is bit-equal with zero
    partial rows.  Hedging is off, so the batch can only complete through
    the failover path."""
    fab = _replicated(port_index, 4, tick_s=0.01)
    fab.start()
    try:
        _live_batch(fab, queries[:16])
        fab.inject(FaultEvent(0.0, "kill", 1, silent=True), 1)
        out = _live_batch(fab, queries[:32])
        assert fab.epochs[1].finalized.wait(timeout=5.0)
    finally:
        fab.close()
    np.testing.assert_array_equal(out.ids, ref_result.ids[:32])
    np.testing.assert_array_equal(out.dists, ref_result.dists[:32])
    assert not out.partial.any()
    assert 1 in fab.failed and fab.alive_shards() == [0, 2, 3]
    assert [f["shard"] for f in fab.stats.failovers] == [1]
    assert fab.stats.failovers[0]["lost"] == 0
    assert fab.stats.timeouts == 0 and fab.stats.hedges == 0
    assert not fab.owner_mask[1].any()
    assert fab.epochs[1].retired
    assert fab.nodes[1].tier.released
    assert not fab.nodes[0].tier.released


def test_unreplicated_kill_degrades_to_partial(port_index, queries):
    """No replicas: killing a shard loses its clusters.  Queries probing
    them are stamped partial (served from the surviving shards, never
    dropped or hung); untouched queries stay bit-equal to their pre-kill
    answers.  nprobe is capped so some rows miss the dead shard."""
    fab = _fabric(port_index, 4, tick_s=0.01, harvest_timeout_s=2.0)
    fab.start()
    try:
        pre = fab.harvest(fab.dispatch(fab.prefetch(
            fab.plan(queries[:32], CFG.k, nprobe_cap=2))))
        fab.inject(FaultEvent(0.0, "kill", 1, silent=True), 1)
        out = fab.harvest(fab.dispatch(fab.prefetch(
            fab.plan(queries[:32], CFG.k, nprobe_cap=2))))
        plan = fab.plan(queries[:32], CFG.k, nprobe_cap=2)
    finally:
        fab.close()
    assert not pre.partial.any()
    assert fab.stats.failovers and fab.stats.failovers[0]["lost"] > 0
    assert fab.lost
    cids, pmask = plan.cids[:32], plan.pmask[:32]
    lost = np.fromiter(fab.lost, np.int64, len(fab.lost))
    expect = (np.isin(cids, lost) & pmask & (cids >= 0)).any(axis=1)
    np.testing.assert_array_equal(out.partial, expect)
    assert expect.any() and (~expect).any()
    np.testing.assert_array_equal(out.ids[~expect], pre.ids[~expect])
    assert fab.stats.partial_queries == int(expect.sum())


def test_stall_triggers_hedge_and_stays_correct(port_index, queries,
                                                ref_result):
    """A shard stalled for longer than the test holds its tasks; the
    batch can complete only through the hedge onto the other replica, and
    it does, bit-equal, with the stalled shard still alive."""
    fab = _replicated(port_index, 4, hedge_after_s=0.02)
    fab.start()
    try:
        fab.inject(FaultEvent(0.0, "stall", duration_s=600.0,
                              stall_s=600.0), 2)
        out = _live_batch(fab, queries[:32])
        served_by_2 = int(fab.stats.tasks_per_shard[2])
    finally:
        fab.close()
    np.testing.assert_array_equal(out.ids, ref_result.ids[:32])
    np.testing.assert_array_equal(out.dists, ref_result.dists[:32])
    assert not out.partial.any()
    assert fab.stats.hedges >= 1 and fab.stats.timeouts == 0
    assert served_by_2 == 0                    # no reply came from shard 2
    assert 2 not in fab.failed                 # straggler, not a corpse


def _held_batch(fab, queries):
    """One batch fanned out to a fabric whose workers never start: its
    tasks stay outstanding, one on each shard, until the test drops them."""
    state = fab.dispatch(fab.prefetch(fab.plan(queries, CFG.k)))
    shards = sorted(r.task.shard for r in fab._outstanding.values())
    assert shards == list(range(fab.n_shards))
    return state


def _drain_shard(fab, shard):
    for tid in [t for t, r in fab._outstanding.items()
                if r.task.shard == shard]:
        fab._drop_outstanding(tid)


def test_hedges_go_only_to_a_less_loaded_replica(port_index, queries):
    """Under load every task outlives ``hedge_after_s``: none is copied
    onto a replica as loaded as its own shard.  Once shard 0 has drained,
    shard 2's task (its clusters replicated on 0) is, and that copy is
    never hedged back."""
    now = [0.0]
    fab = _replicated(port_index, 4, hedge_after_s=0.02,
                      clock=lambda: now[0])
    try:
        state = _held_batch(fab, queries[:32])
        now[0] += 1.0
        fab._hedge_due(state)
        assert fab.stats.hedges == 0
        _drain_shard(fab, 0)
        fab._hedge_due(state)
        hedged = [r.task.shard for r in fab._outstanding.values()
                  if r.task.kind == "hedge"]
        assert fab.stats.hedges == 1 and hedged == [0]
        _drain_shard(fab, 2)               # the straggler idles; the copy
        now[0] += 1.0                      # on 0 is old and still owed
        fab._hedge_due(state)
        assert fab.stats.hedges == 1
    finally:
        fab.close()


def test_hedge_threshold_follows_the_task_latencies(port_index, queries):
    """Once ``HEDGE_MIN_SEEN`` tasks have answered, a task is hedged only
    past the 95th percentile of their latencies, not at
    ``hedge_after_s``."""
    now = [0.0]
    fab = _replicated(port_index, 4, hedge_after_s=0.02,
                      clock=lambda: now[0])
    try:
        fab._latencies.extend([2.0] * HEDGE_MIN_SEEN)
        state = _held_batch(fab, queries[:32])
        _drain_shard(fab, 0)
        now[0] += 1.0
        fab._hedge_due(state)
        assert fab.stats.hedges == 0
        now[0] += 1.5
        fab._hedge_due(state)
        assert fab.stats.hedges == 1
    finally:
        fab.close()


def test_corrupt_payload_detected_and_retried(port_index, queries,
                                              ref_result):
    """Bit flips after the checksum: the router's re-hash rejects the
    reply and retries until a clean copy lands."""
    fab = _replicated(port_index, 4, retry_budget=500)
    fab.start()
    try:
        fab.inject(FaultEvent(0.0, "corrupt", duration_s=0.15), 3)
        out = _live_batch(fab, queries[:32])
    finally:
        fab.close()
    np.testing.assert_array_equal(out.ids, ref_result.ids[:32])
    np.testing.assert_array_equal(out.dists, ref_result.dists[:32])
    assert not out.partial.any()
    assert fab.stats.checksum_failures >= 1 and fab.stats.retries >= 1
    assert not fab.failed and fab.stats.timeouts == 0


# -------------------------------------------------------------------------
# the kill drill through the engine
# -------------------------------------------------------------------------
def _kill_drill(port_index, q, n_arrivals_qps, duration, obs=None):
    """Shard-skewed live traffic through ServeEngine over a fabric whose
    hot shard 1 is killed at the middle arrival's time, so the kill always
    lands inside the trace.  Returns (fab, engine, trace, injector,
    completions)."""
    probe = _fabric(port_index, 4)
    hot = np.nonzero(probe.rmap0.replicas[:, 0] == 1)[0]
    hot_rows = np.nonzero(probe.query_shards(q) == 1)[0]
    probe.close()
    trace = shard_skewed_trace(n_arrivals_qps, duration, q.shape[0],
                               hot_rows, seed=3)
    inj = FaultInjector(seed=7).kill(trace[len(trace) // 2].t, shard=1)
    fab = _fabric(port_index, 4, hot_clusters=hot, injector=inj,
                  tick_s=0.02, obs=obs)
    fab.warmup()
    fab.start()
    eng = ServeEngine({"default": fab},
                      DynamicBatcher(BatchPolicy(max_batch=16,
                                                 max_wait_s=0.004),
                                     ["default"]), obs=obs)
    eng.start()
    try:
        t0 = time.monotonic()
        inj.arm(t0)
        for a in trace:
            lag = t0 + a.t - time.monotonic()
            if lag > 0:
                time.sleep(lag)                # arrival pacing
            assert eng.submit(q[a.qrow], CFG.k) >= 0
    finally:
        eng.stop(drain=True)
        fab.stop()
    return fab, eng, trace, inj, eng.qp.poll()


def test_engine_kill_drill_zero_drop(port_index, queries):
    """Every submitted query completes "ok" (zero dropped, partial or
    failed), exactly one failover fires with nothing lost, and the
    post-failover fabric stays bit-equal to a single shard."""
    fab, eng, trace, inj, comps = _kill_drill(port_index, queries, 300, 0.8)
    try:
        assert eng.stats.submitted == len(trace) == len(comps)
        assert eng.stats.completed == len(trace)
        assert eng.stats.failed == 0 and eng.stats.shed == 0
        assert eng.stats.partial == 0
        assert {c.status for c in comps} == {"ok"}
        assert [(k, s) for _, k, s in inj.log] == [("kill", 1)]
        assert [f["shard"] for f in fab.stats.failovers] == [1]
        assert fab.stats.failovers[0]["lost"] == 0
        assert fab.stats.timeouts == 0 and fab.stats.partial_queries == 0
        assert fab.stats.dead_replies + fab.stats.requeued_tasks >= 1
        assert fab.epochs[1].finalized.wait(timeout=5.0)
        ref = _fabric(port_index, 1)
        post = fab.scan_sync(queries[:32], CFG.k)
        want = ref.scan_sync(queries[:32], CFG.k)
        ref.close()
    finally:
        fab.close()
    assert recall_at_k(post.ids, want.ids) == 1.0
    np.testing.assert_array_equal(post.dists, want.dists)
    assert not post.partial.any()


def test_kill_drill_trace_integrity(port_index, queries):
    """The drill at sample_rate 1.0: the exported trace is well nested,
    every admitted request has exactly one terminal event, and the killed
    shard's requeued tasks carry real request ids that reached the merge
    and finished ok."""
    obs = Observability(sample_rate=1.0)
    fab, eng, trace, inj, _ = _kill_drill(port_index, queries, 150, 0.8,
                                          obs=obs)
    fab.close()
    assert eng.stats.completed == len(trace)
    assert fab.stats.requeued_tasks >= 1
    te = obs.trace.export()["traceEvents"]
    assert check_well_nested(te) == []
    begun, terms = set(), {}
    requeued, merged, done_ok = set(), set(), set()
    for e in te:
        args = e.get("args") or {}
        if e["ph"] == "b" and e["name"] == "request":
            begun.add(args["trace_id"])
        elif e["ph"] == "i" and e["name"].startswith("done:"):
            terms[args["trace_id"]] = terms.get(args["trace_id"], 0) + 1
            if e["name"] == "done:ok":
                done_ok.add(args["trace_id"])
        elif e["ph"] == "b" and e["name"] == "task" \
                and args.get("kind") == "requeue":
            requeued.update(args["trace_ids"])
        elif e["ph"] == "X" and e["name"] == "merge":
            merged.update(args["trace_ids"])
    assert len(begun) == len(trace)
    assert set(terms) == begun and all(n == 1 for n in terms.values())
    assert requeued and requeued <= begun
    assert requeued <= merged and requeued <= done_ok


# -------------------------------------------------------------------------
# coverage proxy and primary-shard stamps
# -------------------------------------------------------------------------
def test_fabric_coverage_and_primary_shard_stamps(port_index):
    import types

    fab = _fabric(port_index, 4)
    fab.close()
    pcids = np.array([[0, 1, 2, 3], [0, 2, -1, -1], [2, 3, -1, -1]],
                     np.int64)
    state = types.SimpleNamespace(
        plan=types.SimpleNamespace(cids=pcids), lost=set())
    np.testing.assert_allclose(fab._coverage(state, 3), [1.0, 1.0, 1.0])
    state.lost = {1, 3}
    w = 1.0 / (1.0 + np.arange(4, dtype=np.float64))
    exp0 = 1.0 - (w[1] + w[3]) / w.sum()
    exp2 = 1.0 - w[1] / (w[0] + w[1])
    np.testing.assert_allclose(fab._coverage(state, 3), [exp0, 1.0, exp2],
                               rtol=1e-6)
    home = types.SimpleNamespace(
        plan=types.SimpleNamespace(cids=pcids[:1]), lost={0})
    tail = types.SimpleNamespace(
        plan=types.SimpleNamespace(cids=pcids[:1]), lost={3})
    assert fab._coverage(home, 1)[0] < fab._coverage(tail, 1)[0]
    cids = np.array([[0, 1], [2, -1], [3, 0]], np.int64)
    shards = fab._primary_shards(
        types.SimpleNamespace(plan=types.SimpleNamespace(cids=cids)), 3)
    np.testing.assert_array_equal(
        shards, fab.striping.shard_of(np.array([0, 2, 3])))


def test_fabric_needs_a_card_unless_asked_for_the_cpu(port_index,
                                                      monkeypatch):
    """Without ``device`` the fabric plans on the card and raises where
    there is none; nothing drops to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedFabric(port_index, None, CFG, n_shards=2)
