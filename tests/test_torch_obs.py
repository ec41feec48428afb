"""The port's telemetry, storage-layout, failover and version modules
against the JAX package's: the same inputs through both give the same
histogram quantiles, SLO transitions, quality summaries, harvest files,
arena extents, striping, replica maps, failover plans, heartbeat verdicts
and epoch swaps.  None of these modules touches a tensor; the reference
keeps them in numpy and pure Python, and so does the port."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import torch_threads  # noqa: E402,F401


def _pkg(name):
    """(reference module, port module) of ``name`` under repro/repro_torch."""
    import importlib

    return (importlib.import_module(f"repro.{name}"),
            importlib.import_module(f"repro_torch.{name}"))


# -------------------------------------------------------------------------
# metrics and trace
# -------------------------------------------------------------------------
@pytest.mark.parametrize("dist", ["lognormal", "uniform", "one_sample"])
def test_histogram_quantiles_equal_reference(dist):
    jm, tm = _pkg("obs.metrics")
    rng = np.random.default_rng(7)
    vals = {"lognormal": rng.lognormal(-4.0, 1.0, 5000),
            "uniform": rng.uniform(1e-3, 2.0, 3000),
            "one_sample": np.array([0.0123])}[dist]
    hj, ht = jm.Histogram("lat"), tm.Histogram("lat")
    hj.observe_many(vals[: len(vals) // 2])
    ht.observe_many(vals[: len(vals) // 2])
    for v in vals[len(vals) // 2:]:
        hj.observe(float(v))
        ht.observe(float(v))
    for q in (0.5, 0.9, 0.99):
        assert ht.quantile(q) == hj.quantile(q)
    assert ht.summary_ms() == hj.summary_ms()
    assert ht.to_dict() == hj.to_dict()
    if len(vals) > 1:
        assert abs(ht.quantile(0.5) - np.percentile(vals, 50)) \
            <= 0.02 * np.percentile(vals, 50)


def test_metrics_registry_render_equals_reference():
    jm, tm = _pkg("obs.metrics")
    regs = (jm.MetricsRegistry(), tm.MetricsRegistry())
    for reg in regs:
        reg.counter("engine.completions").inc(3, "ok")
        reg.counter("engine.completions").inc(1, "shed")
        reg.gauge("engine.pending").set(7)
        h = reg.histogram("engine.latency_s")
        for v in (0.01, 0.02, 0.5):
            h.observe(v)
    assert regs[1].render() == regs[0].render()
    assert regs[1].snapshot() == regs[0].snapshot()


def test_trace_export_equals_reference_and_nests():
    jt, tt = _pkg("obs.trace")
    docs = []
    for mod in (jt, tt):
        clock = iter(np.arange(0.0, 100.0, 0.001)).__next__
        rec = mod.TraceRecorder(1.0, clock=clock)
        tid = rec.mint()
        rec.abegin("request", f"req-{tid}", t=0.0, trace_id=tid,
                   track="requests")
        rec.span("batch", 0.001, 0.009, trace_id=tid, track="batch-0")
        rec.span("plan", 0.001, 0.002, track="batch-0")
        rec.span("scan", 0.003, 0.008, track="batch-0")
        rec.instant("done:ok", t=0.01, trace_id=tid, track="requests")
        rec.aend("request", f"req-{tid}", t=0.01, track="requests")
        docs.append(rec.export())
    assert json.dumps(docs[1], sort_keys=True) \
        == json.dumps(docs[0], sort_keys=True)
    tt.check_well_nested(docs[1]["traceEvents"])


# -------------------------------------------------------------------------
# SLO burn-rate alerts, quality monitor, harvest ring
# -------------------------------------------------------------------------
def _slo_run(mod_slo, mod_metrics):
    """A scripted bad-event stream on a virtual clock: quiet, a burst of
    deadline misses, quiet again.  Returns (state per tick, final
    snapshot)."""
    reg = mod_metrics.MetricsRegistry()
    tracker = mod_slo.SLOTracker(metrics=reg, clock=lambda: 0.0)
    mod_slo.default_rules(tracker, reg, fast_s=2.0, slow_s=8.0)
    comp = reg.counter("engine.completions")
    states = []
    for step in range(40):
        t = step * 0.5
        bad = 10 <= step < 18
        comp.inc(20, "degraded" if bad else "ok")
        if bad:
            reg.counter("engine.not_ok").inc(20, "deadline")
        states.append({k: v for k, v in tracker.tick(now=t).items()})
    return states, tracker.snapshot()


def test_slo_transitions_equal_reference():
    (js, ts), (jmx, tmx) = _pkg("obs.slo"), _pkg("obs.metrics")
    want, want_snap = _slo_run(js, jmx)
    got, got_snap = _slo_run(ts, tmx)
    assert got == want
    assert got_snap == want_snap
    fired = [s for s in got if "firing" in s.values()]
    assert fired and got[-1] == got[0]          # fired, then cleared


def _quality_run(mods, vectors, tmp_path, tag):
    """One QualityMonitor fed three scripted batches through the package's
    own SearchRequest/Completion, with shadow audits on; returns (summary,
    harvest records)."""
    obs, engine = mods
    reg = obs.MetricsRegistry()
    ring = obs.HarvestRing(capacity=16)
    mon = obs.QualityMonitor(reg, vectors=vectors, shadow_rate=0.5,
                             harvest=ring)
    rng = np.random.default_rng(3)
    rid = 0
    for b in range(3):
        reqs, comps = [], []
        for i in range(8):
            q = vectors[rng.integers(0, len(vectors))] \
                + 0.05 * rng.normal(size=vectors.shape[1])
            reqs.append(engine.SearchRequest(
                req_id=rid, index="sift", query=q.astype(np.float32),
                topk=5, deadline=None, arrival=0.1 * rid, trace_id=rid + 1))
            d = ((vectors - q) ** 2).sum(1)
            ids = np.argsort(d, kind="stable")[:5].astype(np.int32)
            if i % 3 == 0:
                ids[-1] = (ids[-1] + 1) % len(vectors)
            status = "degraded" if i == 7 else "ok"
            comps.append(engine.Completion(
                req_id=rid, index="sift", status=status, ids=ids,
                dists=np.zeros(5, np.float32), nprobe=4 + i,
                submitted=0.1 * rid, completed=0.1 * rid + 0.02,
                reason="deadline" if status != "ok" else "",
                trace_id=rid + 1, quality=1.0 - 0.2 * (i % 3 == 0)))
            rid += 1
        mon.observe_batch(reqs, comps, rerank_rounds=b + 1)
    mon.close()
    path = tmp_path / f"{tag}.npz"
    ring.flush_npz(str(path))
    return mon.summary(), obs.load_npz(str(path)), len(ring), ring.dropped


def test_quality_summary_and_harvest_roundtrip_equal_reference(tmp_path):
    import repro.obs as jobs
    import repro.runtime.engine as jeng
    import repro_torch.obs as tobs
    import repro_torch.runtime.engine as teng

    vectors = np.random.default_rng(0).normal(size=(300, 8)).astype(
        np.float32)
    want = _quality_run((jobs, jeng), vectors, tmp_path, "jax")
    got = _quality_run((tobs, teng), vectors, tmp_path, "torch")
    assert got[0] == want[0]
    assert got[0]["audits_done"] > 0 and got[0]["low_proxy"] > 0
    assert got[1] == want[1]
    assert got[2] == 16 and got[3] == 24 - 16       # ring bound held


@pytest.mark.parametrize("ids,true_ids,k,want", [
    ([1, 2, 3], [3, 2, 1], 3, 1.0), ([1, 2, -1], [1, 5, 6], 3, 1 / 3),
    ([4, 5], [6, 7], 2, 0.0)])
def test_quality_primitives_equal_reference(ids, true_ids, k, want):
    jq, tq = _pkg("obs.quality")
    ids, true_ids = np.asarray(ids), np.asarray(true_ids)
    assert tq.overlap_frac(ids, true_ids, k) \
        == jq.overlap_frac(ids, true_ids, k) == pytest.approx(want)
    pre = np.array([[1, 2, 3], [4, 5, 6]])
    post = np.array([[3, 2, 9], [7, 8, 9]])
    np.testing.assert_array_equal(tq.recall_proxy(pre, post, 3),
                                  jq.recall_proxy(pre, post, 3))
    assert [tq.shadow_sampled(i, 0.1) for i in range(200)] \
        == [jq.shadow_sampled(i, 0.1) for i in range(200)]


# -------------------------------------------------------------------------
# arena, layout, failover, heartbeat
# -------------------------------------------------------------------------
@pytest.mark.parametrize("n_clusters,cluster_bytes,n_shards", [
    (20614, 128 * 128 * 4, 8), (37, 128 * 32 * 4, 8), (500, 5000, 3)])
def test_arena_striping_replicas_failover_equal_reference(
        n_clusters, cluster_bytes, n_shards, tmp_path):
    (ja, ta), (jl, tl) = _pkg("storage.arena"), _pkg("storage.layout")
    jf, tf = _pkg("distributed.fault")
    out = []
    for arena_m, layout_m, fault_m in ((ja, jl, jf), (ta, tl, tf)):
        arena = arena_m.ChunkArena(n_devices=12, device_bytes=1 << 30,
                                   chunk_bytes=1 << 20)
        ext = arena.allocate_index("a", n_clusters, cluster_bytes)
        arena.allocate_index("b", 9, cluster_bytes)
        st = layout_m.plan_striping(n_clusters, n_shards, ext)
        hot = np.arange(n_clusters)[::3]
        rmap = layout_m.make_replica_map(n_clusters, n_shards, st,
                                         hot_clusters=hot, n_replicas=2)
        plan = fault_m.plan_failover(rmap, [int(rmap.replicas[0, 0])])
        meta = layout_m.IndexMeta(name="a", n_clusters=n_clusters,
                                  cluster_len=128, dim=32, dtype="int8",
                                  extents=ext)
        free_mid = arena.free_bytes
        arena.release_index("a")
        arena.validate()
        own = fault_m.ownership_mask(rmap.replicas[:, 0], n_shards)
        out.append(([dataclasses.astuple(e) for e in ext], st.perm.tolist(),
                    st.cluster_to_row.tolist(), rmap.replicas.tolist(),
                    sorted(plan.moved.items()) if isinstance(plan.moved, dict)
                    else np.asarray(plan.moved).tolist(),
                    plan.n_lost, json.loads(meta.to_json()), free_mid,
                    arena.free_bytes, np.asarray(own).tolist()))
    assert out[1] == out[0]
    with pytest.raises(ta.OutOfSpace):
        ta.ChunkArena(n_devices=1, device_bytes=1 << 20,
                      chunk_bytes=1 << 20).allocate_index("x", 100, 1 << 19)


def test_heartbeat_and_injector_equal_reference():
    jf, tf = _pkg("distributed.fault")
    runs = []
    for mod in (jf, tf):
        hb = mod.HeartbeatMonitor(8)
        verdicts = []
        for tick in range(8):
            hb.tick()
            for s in range(8):
                if not (s == 3 and tick >= 2):
                    hb.beat(s, latency=0.01 * (1 + (s == 5) * 9))
            verdicts.append((hb.failed().tolist(), hb.stragglers().tolist()))
        inj = mod.FaultInjector(seed=4).kill(1.0).stall(2.0, duration_s=0.5)
        inj.arm(0.0)
        runs.append((verdicts, inj.pick_victim([0, 2, 5, 7]),
                     [dataclasses.astuple(e) for e in inj.events]))
    assert runs[1] == runs[0]
    assert 3 in runs[1][0][-1][0]


# -------------------------------------------------------------------------
# epoch-tagged versions
# -------------------------------------------------------------------------
class _Tier:
    def __init__(self):
        self.released = False

    def release(self):
        self.released = True


class _Pipe:
    def __init__(self):
        self.tier = _Tier()


def _version_run(mod):
    vm = mod.VersionManager(clock=lambda: 0.0)
    p0, p1 = _Pipe(), _Pipe()
    vm.deploy("sift", p0)
    e = vm.route("sift")                   # a batch in flight on epoch 1
    old, new = vm.swap("sift", p1)
    before = (old.finalized.is_set(), p0.tier.released, old.inflight)
    vm.harvested(e)                        # its last batch harvests
    after = (old.finalized.is_set(), p0.tier.released, old.inflight)
    return (old.eid, new.eid, before, after, vm.current("sift").pipeline is p1,
            old.record.batches, p1.tier.released)


def test_version_swap_and_retire_equal_reference():
    jv, tv = _pkg("lifecycle.version")
    want, got = _version_run(jv), _version_run(tv)
    assert got == want
    assert got[2] == (False, False, 1) and got[3] == (True, True, 0)
