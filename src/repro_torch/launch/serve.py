"""Serving launcher (port of ``repro.launch.serve``): the single-node
daemon and the sharded fabric drill.

A node daemon over the port's serving runtime: arrivals from a seeded
multi-tenant Poisson trace are submitted one query at a time to the
``ServeEngine``'s SQ/CQ queue pair, the ``DynamicBatcher`` coalesces them
per index with locality grouping and deadline-aware shed/degrade, and the
``PrefetchPipeline`` overlaps each batch's host gather + copy to the card
with the previous batches' scans (depth 2).

Responsibilities (container-scale versions of the production node):
  * index deployment: build indexes on the card, allocate their cluster
    extents from the node's ChunkArena (multi-index hosting, §4.2), publish
    IndexMeta, wrap the postings in a streamed host tier + pipeline (the q8
    tier + flash re-rank by default);
  * traffic: open-loop Poisson tenants through the ServeEngine (§4.1);
  * health: heartbeat table per logical shard and replica failover planning
    on a simulated shard failure (``--fail-shard``), recall probes through
    the engine, quality/SLO telemetry;
  * freshness: a mid-run rebuild + epoch swap (``--rebuild``) while the
    engine keeps serving;
  * fleet (``--shards S > 0``, :func:`run_fabric`): one index behind the
    sharded, replicated fabric (``distributed/fabric.py``), with a seeded
    kill of a live shard mid-trace (``--kill-shard-at``).

The scan runs the port's CUDA kernels on the card (``--device cuda``, the
default); ``--device cpu`` runs their plain versions, and ``--no-kernel``
picks the packed-domain oracle instead of the fused scan.  In fabric mode
the planner and the merge run on the device and the shard scans in numpy
on the host, as in the reference.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --indexes 2 --duration 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 4000
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 --replicas 2 \
      --kill-shard-at 2 --duration 6
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.build.pipeline import BuildConfig, build_index
from repro_torch.core.distance import recall_at_k
from repro_torch.core.ivf import brute_force_topk
from repro_torch.core.llsp import LLSPConfig
from repro_torch.core.search import SearchConfig
from repro_torch.data.synthetic import PAPER_DATASETS, make_queries, \
    make_vectors
from repro_torch.device import resolve_device
from repro_torch.distributed import (
    FaultInjector,
    HeartbeatMonitor,
    ShardedFabric,
    plan_failover,
)
from repro_torch.lifecycle import VersionManager
from repro_torch.obs import (
    HarvestRing,
    Observability,
    QualityMonitor,
    SLOTracker,
    default_rules,
    health_snapshot,
    write_health,
)
from repro_torch.runtime import (
    BatchPolicy,
    DynamicBatcher,
    PrefetchPipeline,
    RerankConfig,
    ServeEngine,
    TenantSpec,
    make_quantized_pipeline,
    multi_tenant_trace,
)
from repro_torch.runtime.pipeline import _vectors_from_postings
from repro_torch.storage import ChunkArena, IndexMeta, TieredPostings, \
    make_replica_map, plan_striping

@dataclasses.dataclass
class Deployment:
    name: str
    index: object
    llsp: object
    spec: object
    meta: IndexMeta
    striping: object
    replica_map: object
    pipeline: PrefetchPipeline
    queries: np.ndarray          # probe pool for recall spot checks
    true10: np.ndarray


def deploy(arena: ChunkArena, name: str, spec, workdir: str,
           n_shards: int, scfg: SearchConfig, tier: str = "q8",
           rerank: Optional[RerankConfig] = None,
           with_rerank: bool = True, device=None,
           obs: Optional[Observability] = None) -> Deployment:
    """Build one index on ``device`` (the reference's build settings) and
    deploy it with :func:`deploy_built`; with ``obs`` tracing, the build
    records its spans."""
    x = make_vectors(spec)
    q, topk = make_queries(spec, 256)
    topk = np.minimum(topk, 50).astype(np.int32)
    cfg = BuildConfig(max_cluster_size=96, cluster_len=128,
                      coarse_per_task=5000, n_workers=2,
                      llsp=LLSPConfig(levels=(8, 16), n_ratio_features=8))
    t0 = time.perf_counter()
    index, llsp, report = build_index(x, cfg, workdir, queries=q,
                                      query_topk=topk, device=device,
                                      obs=obs)
    note = (f"build {time.perf_counter() - t0:.1f}s ("
            + " ".join(f"{k} {v:.1f}s"
                       for k, v in report.stage_seconds.items()) + "), "
            f"build overlap {report.shard_overlap:.2f} "
            f"({len(report.shard_stamps)} shards)")
    return deploy_built(arena, name, spec, workdir, n_shards, scfg, index,
                        llsp, x, q, tier=tier, rerank=rerank,
                        with_rerank=with_rerank, device=device,
                        build_note=note)


def deploy_built(arena: ChunkArena, name: str, spec, workdir: str,
                 n_shards: int, scfg: SearchConfig, index, llsp,
                 vectors: np.ndarray, queries: np.ndarray, *,
                 tier: str = "q8", rerank: Optional[RerankConfig] = None,
                 with_rerank: bool = True, device=None,
                 build_note: str = "") -> Deployment:
    """Deploy a built index: arena extents, striping over ``n_shards``,
    replica map (every third cluster hot, 2 replicas), IndexMeta, and the
    serving pipeline of ``tier``; ground truth of ``queries`` for the
    recall probes."""
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    cluster_bytes = index.cluster_len * index.dim * 4
    extents = arena.allocate_index(name, index.n_clusters, cluster_bytes)
    striping = plan_striping(index.n_clusters, n_shards, extents)
    hot = np.arange(index.n_clusters)[::3]
    rmap = make_replica_map(index.n_clusters, n_shards, striping,
                            hot_clusters=hot, n_replicas=2)
    meta = IndexMeta(name=name, n_clusters=index.n_clusters,
                     cluster_len=index.cluster_len, dim=index.dim,
                     dtype="int8" if tier == "q8" else "float32",
                     extents=extents)
    meta.save(os.path.join(workdir, f"{name}.meta.json"))
    if tier == "q8":
        # quantized serving default: q8 hot tier + mmap flash tier (f32
        # corpus, arena-accounted) + adaptive f32 re-rank at harvest
        pipeline = make_quantized_pipeline(
            index, llsp, scfg, arena=arena, name=name, vectors=vectors,
            flash_path=os.path.join(workdir, f"{name}.flash.f32"),
            rerank=rerank, with_flash=with_rerank, device=dev)
    else:
        hot_tier = TieredPostings(index.postings.cpu().numpy(),
                                  index.posting_ids.cpu().numpy(),
                                  device=dev)
        pipeline = PrefetchPipeline(index, llsp, scfg, tier=hot_tier,
                                    device=dev)
    _, t10 = brute_force_topk(torch.from_numpy(vectors).to(dev),
                              torch.from_numpy(queries).to(dev), 10)
    hot_note = ""
    if tier == "q8":
        f32_bytes = index.postings.numel() * 4 + index.posting_ids.numel() * 4
        fl = (f" + flash {pipeline.flash.nbytes >> 20} MiB"
              if pipeline.flash is not None else ", rerank off")
        hot_note = (f", hot {pipeline.tier.nbytes() >> 20} MiB "
                    f"({pipeline.tier.nbytes() / f32_bytes:.2f}x f32)" + fl)
    print(f"[deploy] {name}: {index.n_clusters} clusters, "
          f"{len({e.device for e in extents})} devices, "
          f"arena free {arena.free_bytes >> 20} MiB, "
          + (f"{build_note}, " if build_note else "")
          + f"dup_bound {pipeline.dup_bound}, tier={pipeline.tier_kind}, "
            f"device={dev.type}" + hot_note, flush=True)
    return Deployment(name, index, llsp, spec, meta, striping, rmap,
                      pipeline, queries, t10.cpu().numpy())


def undeploy(arena: ChunkArena, dep: Deployment) -> None:
    dep.pipeline.close()
    if dep.pipeline.flash is not None:
        dep.pipeline.flash.release()   # mmap file + its arena chunks
    arena.release_index(dep.name)
    print(f"[undeploy] {dep.name}: chunks recycled "
          f"(arena free {arena.free_bytes >> 20} MiB)")


def probe_recall(engine: ServeEngine, dep: Deployment, lat, tenant: str,
                 n: int = 64) -> float:
    """Submit known queries THROUGH the engine and score the completions —
    the health check exercises the exact serving path, not a side door.
    Non-probe completions drained along the way keep feeding ``lat``."""
    comps, rows = probe_completions(engine, dep.queries[:n], tenant, lat)
    if not rows:
        return float("nan")
    ids = np.stack([c.ids for c in comps])
    return recall_at_k(ids[:, :10], dep.true10[rows])


def probe_completions(engine: ServeEngine, queries: np.ndarray, tenant: str,
                      lat=None, timeout_s: float = 60.0):
    """Submit ``queries`` (top-k 10) through the engine; returns (the
    completions that carry ids, in submission order; their query rows)."""
    want = {}
    for i, q in enumerate(queries):
        rid = engine.submit(q, 10, index=tenant, block=True)
        if rid >= 0:
            want[rid] = i
    deadline = time.monotonic() + timeout_s
    got: dict = {}
    while len(got) < len(want) and time.monotonic() < deadline:
        for c in engine.qp.poll():
            if c.req_id in want:
                if c.ids is not None:
                    got[c.req_id] = c
                else:
                    want.pop(c.req_id)
            elif c.status != "shed" and lat is not None:
                lat.append(c.latency)
        time.sleep(0.01)
    order = sorted(got, key=want.get)
    return [got[r] for r in order], [want[r] for r in order]


def make_obs(args) -> Observability:
    """One telemetry bundle per serve run: metrics are always live (they
    are the bounded-memory latency accounting), tracing turns on iff
    ``--trace-out`` was given, at ``--sample-rate``."""
    return Observability(args.sample_rate, enabled=bool(args.trace_out))


def finish_obs(obs: Observability, args) -> None:
    """End-of-run telemetry flush: metrics summary + Perfetto export."""
    if args.metrics_every > 0:
        for line in obs.metrics.render():
            print(f"[metrics] {line}")
    if args.trace_out:
        doc = obs.trace.export(args.trace_out)
        print(f"[trace] {len(doc['traceEvents'])} events -> "
              f"{args.trace_out} "
              f"(ring-dropped {doc['otherData']['dropped_events']}); "
              f"open in https://ui.perfetto.dev")


def make_quality_stack(args, obs: Observability, vectors=None):
    """Quality-observability bundle for one serve run: the per-query
    recall-proxy monitor (+ shadow audit lane when ``vectors`` is given),
    the structured harvest ring, and the burn-rate SLO tracker with the
    default serving rules.  ``--no-quality`` returns (None, None, None)."""
    if args.no_quality:
        return None, None, None
    harvest = HarvestRing()
    quality = QualityMonitor(
        obs.metrics, vectors=vectors, shadow_rate=args.shadow_rate,
        harvest=harvest, trace=obs.trace if obs.tracing else None)
    slo = SLOTracker(metrics=obs.metrics,
                     trace=obs.trace if obs.tracing else None)
    # short drills need short windows: scale the multi-window pair to the
    # trace duration (capped at the workbook's 1m/5m defaults)
    fast = min(60.0, max(args.duration / 4.0, 1.0))
    slow = min(300.0, max(args.duration, 4.0))
    default_rules(slo, obs.metrics, quality=quality,
                  fast_s=fast, slow_s=slow)
    return quality, harvest, slo


def emit_health(args, quality, harvest, slo, registry) -> None:
    """Tick the SLO state machine and (when ``--health-out`` is set)
    atomically rewrite the health snapshot JSON an operator polls."""
    if slo is None:
        return
    slo.tick()
    if args.health_out:
        write_health(args.health_out, health_snapshot(
            slo=slo, quality=quality, registry=registry,
            extra={"harvest": {"records": len(harvest),
                               "appended": harvest.appended,
                               "dropped": harvest.dropped}}))


def finish_quality(args, quality, harvest, slo, registry) -> None:
    """End-of-run quality flush: drain the shadow-audit lane, write the
    final health snapshot, persist the harvest shard, print the rollup."""
    if quality is None:
        return
    quality.drain()
    emit_health(args, quality, harvest, slo, registry)
    if args.harvest_out:
        harvest.flush_npz(args.harvest_out)
        print(f"[quality] harvest shard: {len(harvest)} records -> "
              f"{args.harvest_out} (lifetime {harvest.appended}, "
              f"ring-dropped {harvest.dropped})")
    s = quality.summary()
    firing = [n for n, st in slo.snapshot().items()
              if st["state"] == "firing"]
    print(f"[quality] {s['queries']:.0f} queries, proxy p50="
          f"{s['proxy']['p50']:.3f} low_frac={s['low_frac']:.4f}, "
          f"audits done={s['audits_done']:.0f} "
          f"dropped={s['audits_dropped']:.0f}, "
          f"calib p99={s['calibration_err']['p99']:.4f}, "
          f"alerts firing={firing or 'none'}")
    quality.close()


def warm_batch_sizes(policy: BatchPolicy, pad_batch: int) -> tuple:
    """Every padded batch size the batcher can release: any partial size up
    to max_batch, padded to the pipeline's pad_batch multiple."""
    top = -(-policy.max_batch // pad_batch) * pad_batch
    return tuple(range(pad_batch, top + 1, pad_batch))


FABRIC_TIER_ERROR = (
    "--tier q8 is not supported in fabric mode (--shards > 0): the fabric "
    "shards f32 postings and has no quantized tier; drop --tier q8 (fabric "
    "serves f32) or use the single-node pipeline (--shards 0)")


def run_fabric(args) -> dict:
    """Fabric drill mode (``--shards > 0``): one index (dim 32, f32) served
    behind the sharded, replicated fabric through the engine, with the
    quality stack (the fabric's coverage proxy, shadow audits against the
    corpus) and an optional seeded kill mid-trace.  Every cluster is hot
    (replicated) when ``--replicas`` > 1.  Rejects an explicit ``--tier
    q8``.  Prints what the reference prints and returns the numbers."""
    if getattr(args, "tier", None) == "q8":
        raise ValueError(FABRIC_TIER_ERROR)
    if args.health_out and args.health_every <= 0:
        args.health_every = 1.0
    dev = resolve_device(args.device)
    scfg = SearchConfig(k=10, nprobe_max=16, pruning="llsp", n_ratio=8,
                        use_kernel=not args.no_kernel, fused_topk=True)
    arena = ChunkArena(n_devices=12, device_bytes=1 << 30,
                       chunk_bytes=1 << 20)
    deadline_s = args.deadline_ms * 1e-3 or None
    name = list(PAPER_DATASETS)[0]
    with tempfile.TemporaryDirectory() as root:
        spec = dataclasses.replace(PAPER_DATASETS[name], n=args.n, dim=32)
        obs = make_obs(args)
        dep = deploy(arena, name, spec, os.path.join(root, name),
                     args.shards, scfg, tier="f32", device=dev, obs=obs)
        inj = None
        if args.kill_shard_at > 0:
            inj = FaultInjector(seed=0).kill(args.kill_shard_at)
        hot = (np.arange(dep.index.n_clusters) if args.replicas > 1
               else None)
        fab = ShardedFabric(dep.index, dep.llsp, scfg,
                            n_shards=args.shards,
                            n_replicas=args.replicas, hot_clusters=hot,
                            injector=inj, hedge_after_s=0.05, tick_s=0.02,
                            obs=obs, device=dev)
        fab.warmup()
        fab.start()
        # fabric quality: the coverage proxy rides every BatchResult; the
        # shadow audit lane brute-forces against the reconstructed corpus
        quality, harvest, slo = make_quality_stack(
            args, obs, vectors=_vectors_from_postings(dep.index))
        engine = ServeEngine(
            {name: fab},
            DynamicBatcher(BatchPolicy(max_batch=args.batch,
                                       max_wait_s=0.05), [name]),
            depth=args.depth, obs=obs, quality=quality)
        engine.start()
        trace = multi_tenant_trace(
            [TenantSpec(name, args.rate, topk_lo=10, topk_hi=50,
                        deadline_s=deadline_s, n_queries=256)],
            args.duration)
        print(f"[fabric] {args.shards} shards x R={args.replicas}, "
              f"replaying {len(trace)} arrivals over {args.duration:.0f}s"
              + (f", kill drill at t={args.kill_shard_at:.1f}s"
                 if inj is not None else "")
              + f" (device={dev.type})", flush=True)
        t0 = time.monotonic()
        if inj is not None:
            inj.arm(t0)
        # bounded recent window (heartbeat means only); the full-run
        # percentiles come from the engine's streaming latency histogram
        lat: collections.deque = collections.deque(maxlen=2048)
        next_metrics = args.metrics_every or float("inf")
        next_health = args.health_every or float("inf")
        try:
            for arr in trace:
                lag = t0 + arr.t - time.monotonic()
                if lag > 0:
                    time.sleep(lag)
                engine.submit(dep.queries[arr.qrow], arr.topk, index=name,
                              deadline_s=arr.deadline_s)
                if time.monotonic() - t0 >= next_metrics:
                    next_metrics += args.metrics_every
                    for line in obs.metrics.render():
                        print(f"[metrics] {line}")
                if time.monotonic() - t0 >= next_health:
                    next_health += args.health_every
                    emit_health(args, quality, harvest, slo, obs.metrics)
            r = probe_recall(engine, dep, lat, name)
        finally:
            engine.stop(drain=True)
            fab.close()
        engine.qp.poll()
        st, fs = engine.stats, fab.stats
        wall = time.monotonic() - t0
        pct = obs.metrics.histogram("engine.latency_s").summary_ms()
        qps = (st.completed - st.shed) / wall
        print(f"[fabric] {st.completed} completions in {wall:.1f}s "
              f"({qps:.0f} q/s), "
              f"p50={pct['p50_ms']:.0f}ms p99={pct['p99_ms']:.0f}ms, "
              f"shed={st.shed} partial={st.partial} failed={st.failed}")
        for f in fs.failovers:
            print(f"[fault] shard {f['shard']} failed over: "
                  f"{f['moved']} clusters moved to replicas, "
                  f"{f['lost']} lost")
        if inj is not None:
            print(f"[fault] injector log: "
                  f"{[(round(t, 2), k, s) for t, k, s in inj.log]}, "
                  f"dead_replies={fs.dead_replies} "
                  f"requeued={fs.requeued_tasks} hedges={fs.hedges}")
        print(f"[fabric] busy_s per shard: "
              f"{[round(b, 3) for b in fs.busy_s.tolist()]}, tasks "
              f"{fs.tasks_per_shard.tolist()}")
        dropped = st.submitted - st.completed
        print(f"[health] {name}: recall@10={r:.3f} through the engine, "
              f"dropped={dropped} (rejected at submit {st.rejected})")
        finish_quality(args, quality, harvest, slo, obs.metrics)
        finish_obs(obs, args)
        retired = [s for s in sorted(fab.failed)
                   if fab.epochs[s].finalized.is_set()
                   and fab.nodes[s].tier.released]
        undeploy(arena, dep)
        arena.validate()
    return {"device": dev.type, "shards": args.shards,
            "replicas": args.replicas, "arrivals": len(trace),
            "submitted": st.submitted, "rejected": st.rejected,
            "completed": st.completed, "dropped": dropped, "shed": st.shed,
            "partial": st.partial, "failed": st.failed, "wall_s": wall,
            "qps": qps, "p50_ms": pct["p50_ms"], "p99_ms": pct["p99_ms"],
            "recall": r, "failovers": list(fs.failovers),
            "kills": [] if inj is None else [(k, s) for _, k, s in inj.log],
            "retired": retired, "timeouts": fs.timeouts,
            "partial_queries": fs.partial_queries, "hedges": fs.hedges,
            "requeued": fs.requeued_tasks, "dead_replies": fs.dead_replies,
            "busy_s": fs.busy_s.tolist(),
            "tasks_per_shard": fs.tasks_per_shard.tolist()}


def run_single_node(args) -> dict:
    """The single-node serving run: deploy ``--indexes`` indexes, replay an
    open-loop multi-tenant trace through the engine with the optional
    shard-failure drill and mid-run rebuild + swap, probe recall through the
    engine, and flush telemetry.  Prints what the reference prints and
    returns the same numbers.  ``--shards > 0`` is :func:`run_fabric`'s."""
    if args.shards > 0:
        raise ValueError("--shards > 0 is fabric mode: run_fabric(args) "
                         "serves it (main() dispatches by --shards)")
    if args.tier is None:
        args.tier = "q8"               # quantized single-node default
    if args.health_out and args.health_every <= 0:
        args.health_every = 1.0
    dev = resolve_device(args.device)
    n_shards = 8
    arena = ChunkArena(n_devices=12, device_bytes=1 << 30, chunk_bytes=1 << 20)
    hb = HeartbeatMonitor(n_shards)
    scfg = SearchConfig(k=10, nprobe_max=16, pruning="llsp", n_ratio=8,
                        use_kernel=not args.no_kernel, fused_topk=True)
    names = list(PAPER_DATASETS)[: args.indexes]
    deadline_s = args.deadline_ms * 1e-3 or None
    rerank = RerankConfig(round_size=args.rerank_round,
                          stable_rounds=args.rerank_stable)
    deps: dict[str, Deployment] = {}
    tiers_seen: list = []          # every deployed tier, incl. swapped-out
    out: dict = {"device": dev.type, "indexes": names}
    obs = make_obs(args)
    with tempfile.TemporaryDirectory() as root:
        for name in names:
            spec = dataclasses.replace(PAPER_DATASETS[name], n=args.n, dim=32)
            deps[name] = deploy(arena, name, spec,
                                os.path.join(root, name), n_shards, scfg,
                                tier=args.tier, rerank=rerank,
                                with_rerank=not args.no_rerank, device=dev,
                                obs=obs)
            tiers_seen.append(deps[name].pipeline.tier)

        policy = BatchPolicy(max_batch=args.batch, max_wait_s=0.05,
                             shed="degrade", degrade_nprobe=8,
                             grouping=args.grouping)
        batcher = DynamicBatcher(policy, names)
        # shadow audits need one ground-truth corpus: with co-resident
        # indexes the proxy/SLO streams stay on but the audit lane is off
        audit_vecs = (_vectors_from_postings(deps[names[0]].index)
                      if len(names) == 1 else None)
        quality, harvest, slo = make_quality_stack(args, obs,
                                                   vectors=audit_vecs)
        engine = ServeEngine({n: d.pipeline for n, d in deps.items()},
                             batcher, depth=args.depth, obs=obs,
                             quality=quality)
        # epoch-tagged versions: every batch routes to the current epoch at
        # formation and carries it to harvest, so the mid-run rebuild swaps
        # atomically and the old epoch retires after its last harvest
        vm = VersionManager()
        for name in names:
            vm.deploy(name, deps[name].pipeline)
        vm.bind(engine)
        warm_sizes = warm_batch_sizes(policy,
                                      deps[names[0]].pipeline.pad_batch)
        for d in deps.values():
            d.pipeline.warmup(batch_sizes=warm_sizes)
        engine.start()

        trace = multi_tenant_trace(
            [TenantSpec(n, args.rate / len(names), topk_lo=10, topk_hi=50,
                        deadline_s=deadline_s, n_queries=256)
             for n in names],
            args.duration)
        scan = ("oracle" if not scfg.use_kernel
                else "cuda" if dev.type == "cuda" else "plain")
        print(f"[serve] replaying {len(trace)} arrivals over "
              f"{args.duration:.0f}s ({args.rate:.0f} qps offered, "
              f"kernel={scan}, device={dev.type})", flush=True)
        t0 = time.monotonic()
        next_report = 1.0
        next_metrics = args.metrics_every or float("inf")
        next_health = args.health_every or float("inf")
        n_ticks = 0
        # bounded recent window (heartbeat means only); percentiles come
        # from the engine's streaming latency histogram, not a raw list
        lat: collections.deque = collections.deque(maxlen=64)
        lat_hist = obs.metrics.histogram("engine.latency_s")
        failed: list[int] = []
        did_fail = did_rebuild = False
        try:
            for arr in trace:
                lag = t0 + arr.t - time.monotonic()
                if lag > 0:
                    time.sleep(lag)
                dep = deps[arr.index]
                engine.submit(dep.queries[arr.qrow], arr.topk,
                              index=arr.index, deadline_s=arr.deadline_s)
                el = time.monotonic() - t0
                if el >= next_report:
                    # heartbeat ticks every 1s (the monitor needs a few
                    # ticks after a failure to cross its miss threshold);
                    # stats print every other tick
                    while next_report <= el:
                        next_report += 1.0
                    n_ticks += 1
                    comps = engine.qp.poll()
                    lat += [c.latency for c in comps if c.status != "shed"]
                    hb.tick()
                    mean_lat = float(np.mean(lat)) if lat else 0.0
                    for s in range(n_shards):
                        if s not in failed:
                            hb.beat(s, latency=mean_lat)
                    st = engine.stats
                    if n_ticks % 2 == 0:
                        print(f"[serve] t={el:4.1f}s completed="
                              f"{st.completed} batches={st.batches} "
                              f"shed={st.shed} degraded={st.degraded} "
                              f"p50={lat_hist.summary_ms()['p50_ms']:.0f}ms",
                              flush=True)
                if el >= next_metrics:
                    next_metrics += args.metrics_every
                    for line in obs.metrics.render():
                        print(f"[metrics] {line}")
                if el >= next_health:
                    next_health += args.health_every
                    emit_health(args, quality, harvest, slo, obs.metrics)
                if (not did_fail and args.fail_shard >= 0
                        and el > args.duration / 2):
                    did_fail = True
                    dep0 = deps[names[0]]
                    owners = set(dep0.replica_map.replicas[:, 0].tolist())
                    shard = (args.fail_shard if args.fail_shard in owners
                             else int(dep0.replica_map.replicas[0, 0]))
                    failed.append(shard)
                    plan = plan_failover(dep0.replica_map, failed)
                    out["failover"] = {"shard": shard,
                                       "moved": len(plan.moved),
                                       "lost": int(plan.n_lost)}
                    print(f"[fault] shard {shard} down: "
                          f"{len(plan.moved)} clusters on replicas, "
                          f"{plan.n_lost} lost pending re-replication; "
                          f"heartbeat reports failed="
                          f"{hb.failed().tolist()}", flush=True)
                if (not did_rebuild and args.rebuild
                        and el > 2 * args.duration / 3):
                    did_rebuild = True
                    out["swap"] = _rebuild_and_swap(
                        arena, deps, names[0], root, n_shards, scfg, args,
                        rerank, dev, vm, warm_sizes, tiers_seen)
            out["recall"] = {}
            for name, dep in deps.items():
                r = probe_recall(engine, dep, lat, name)
                out["recall"][name] = r
                print(f"[health] {name}: recall@10={r:.3f} "
                      f"(through the engine)")
        finally:
            engine.stop(drain=True)
        engine.qp.poll()
        st = engine.stats
        pct = lat_hist.summary_ms()
        wall = time.monotonic() - t0
        qps = (st.completed - st.shed) / wall
        print(f"[done] {st.completed} completions in {wall:.1f}s "
              f"({qps:.0f} q/s), "
              f"p50={pct['p50_ms']:.0f}ms p99={pct['p99_ms']:.0f}ms, "
              f"shed={st.shed} degraded={st.degraded} "
              f"rejected={st.rejected}")
        bs = batcher.stats
        # released tiers keep their stats (release drops only the payload),
        # so a retired epoch's pre-swap gather traffic still counts here
        union_mib = sum(t.stats.union_bytes_streamed
                        for t in tiers_seen if t is not None) / 2**20
        print(f"[batcher] grouping={args.grouping} depth={args.depth}: "
              f"{bs.batches} batches ({bs.locality_batches} locality-"
              f"formed, {bs.aged_seeds} aged seeds), "
              f"max queue wait {bs.max_queue_wait_s * 1e3:.1f}ms "
              f"(bound {policy.max_wait_s * 1e3:.0f}ms), "
              f"gather union {union_mib:.1f} MiB")
        hb_failed: list = []
        if failed:
            # live shards keep beating through shutdown so the monitor can
            # cross its miss threshold on the silent one
            for _ in range(3):
                hb.tick()
                for s in range(n_shards):
                    if s not in failed:
                        hb.beat(s, latency=1e-3)
            hb_failed = hb.failed().tolist()
            print(f"[health] heartbeat-detected failures at shutdown: "
                  f"{hb_failed} (injected: {failed})")
        finish_quality(args, quality, harvest, slo, obs.metrics)
        finish_obs(obs, args)
        for dep in deps.values():
            undeploy(arena, dep)
        arena.validate()
    out.update(
        submitted=st.submitted, rejected=st.rejected, completed=st.completed,
        shed=st.shed, degraded=st.degraded, failed=st.failed,
        batches=st.batches, wall_s=wall, qps=qps, p50_ms=pct["p50_ms"],
        p99_ms=pct["p99_ms"], arrivals=len(trace),
        dropped=st.submitted - st.completed,
        locality_batches=bs.locality_batches, union_mib=union_mib,
        injected_failures=failed, heartbeat_failed=hb_failed)
    return out


def _rebuild_and_swap(arena, deps, name_r, root, n_shards, scfg, args,
                      rerank, dev, vm, warm_sizes, tiers_seen) -> dict:
    """Rebuild index ``name_r`` on a reseeded corpus and swap it in; the
    old epoch's extents are reclaimed only after its last in-flight batch
    harvests."""
    old = deps[name_r]
    spec = dataclasses.replace(old.spec, seed=old.spec.seed + 1)
    # the rebuild inherits the serving tier: a q8 deployment re-quantizes
    # the fresh epoch's shards before the swap
    fresh = deploy(arena, name_r + "_r1", spec,
                   os.path.join(root, f"{name_r}_r1"), n_shards, scfg,
                   tier=args.tier, rerank=rerank,
                   with_rerank=not args.no_rerank, device=dev)
    tiers_seen.append(fresh.pipeline.tier)
    fresh.pipeline.warmup(batch_sizes=warm_sizes)
    old_ep, new_ep = vm.swap(name_r, fresh.pipeline)
    retired = old_ep.finalized.wait(timeout=30.0)
    if retired:
        undeploy(arena, old)
    else:
        print(f"[swap] WARNING: epoch {old_ep.eid} still has "
              f"{old_ep.inflight} batch(es) in flight; leaking its extents "
              f"instead of freeing under a live scan")
    deps[name_r] = fresh
    print(f"[swap] {name_r} epoch {old_ep.eid} -> {new_ep.eid}: "
          f"{old_ep.record.batches} batches finished on the old epoch, "
          f"retired={retired} (engine kept serving)", flush=True)
    return {"old_epoch": old_ep.eid, "new_epoch": new_ep.eid,
            "old_batches": old_ep.record.batches, "retired": bool(retired)}


RUNBOOK = """\
operator runbook — quantized tier + flash re-rank (single-node default):

  The first pass serves from the int8-residual hot tier (~0.3x the f32
  posting bytes resident in host DRAM), gathered per batch into pinned
  buffers and copied to the card on the tier's own stream; the f32 vectors
  live in a mmap-backed flash file and only the ~2k fused-topk candidates
  per query are read back and exact-rescored at harvest, in rounds, with
  an adaptive stop once the exact top-k is stable.

  --tier q8|f32       first-pass payload (default q8); f32 streams the
                      f32 postings and scans them with the f32 kernel
  --no-rerank         serve raw q8 distances (no flash tier)
  --rerank-round N    candidates exact-scored per re-rank round (64)
  --rerank-stable N   stop after N consecutive rounds leave the exact
                      top-k unchanged (1)
  --device cuda|cpu   where the index and the scans live (default cuda:
                      the CUDA kernels; cpu runs their plain versions)
  --no-kernel         the packed-domain oracle instead of the fused scan
                      kernel (an explicit A/B choice, never a fallback)

operator runbook — drills:

  --fail-shard S      halfway through the trace shard S stops beating;
                      the failover plan moves its clusters to replicas
                      and the heartbeat reports it at shutdown
  --rebuild           two thirds through, index 0 is rebuilt on a
                      reseeded corpus and swapped in; in-flight batches
                      finish on the old epoch, which then retires

operator runbook — sharded fabric mode (--shards > 0):

  Serve one index behind the sharded, replicated fabric instead of the
  single-node pipeline.  The planner (centroid scan + LLSP) and the
  cross-shard merge run on the device; each shard is a worker thread that
  scans its clusters in numpy on the host.  Probed clusters fan out to
  owner shards by power-of-two-choices over live replicas; shard death is
  detected by dead-letter replies or missed heartbeats, failover reroutes
  probes to replicas, stragglers are hedged, and clusters with no live
  replica degrade the touching responses to status="partial", never a
  dropped query.  Fabric mode serves f32 (an explicit --tier q8 is
  refused), and --rebuild and --fail-shard belong to the single-node mode.

  --shards S          number of shards (worker threads)
  --replicas R        copies per cluster (default 2): R=2 survives any
                      single shard death with zero loss; R=1 degrades to
                      partial
  --kill-shard-at T   at T seconds a seeded FaultInjector kills one live
                      shard (0 = no drill); the [fault] lines show the
                      failover, the [health] line the recall through the
                      engine

  drills:
    # zero-drop kill drill: 8 shards, R=2, a shard dies mid-trace
    serve --shards 8 --replicas 2 --kill-shard-at 4 --duration 8
    # the same unreplicated: partial responses, not drops
    serve --shards 8 --replicas 1 --kill-shard-at 4 --duration 8

operator runbook — observability:

  Metrics are always on (streaming histograms/counters/gauges);
  --metrics-every N prints the registry every N seconds.  --trace-out F
  turns tracing on (requests at --sample-rate; every served batch's stages
  and each deployed index's build steps) and writes one Chrome/Perfetto
  trace_event JSON at exit.  The quality layer (on unless --no-quality)
  stamps a per-query recall proxy (rerank agreement on the q8 tier), runs
  shadow audits (--shadow-rate, one index only), burn-rate SLO alerts, and
  a per-query harvest ring: --health-out F rewrites the health snapshot
  JSON every --health-every seconds, --harvest-out F writes the ring as a
  compressed npz at exit.
"""


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve", epilog=RUNBOOK,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--indexes", type=int, default=2)
    ap.add_argument("--duration", type=float, default=8.0,
                    help="seconds of traffic")
    ap.add_argument("--rate", type=float, default=30.0,
                    help="total offered qps across tenants")
    ap.add_argument("--batch", type=int, default=32,
                    help="batcher max micro-batch")
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline (0 = best-effort)")
    ap.add_argument("--depth", type=int, default=2,
                    help="in-flight batch window (1 = double buffer)")
    ap.add_argument("--grouping", choices=("locality", "fifo"),
                    default="locality",
                    help="micro-batch formation: probe-overlap grouping "
                         "or arrival order")
    ap.add_argument("--rebuild", action="store_true",
                    help="rebuild + swap index 0 mid-run (freshness flow)")
    ap.add_argument("--fail-shard", type=int, default=-1,
                    help="simulate this shard failing mid-run")
    ap.add_argument("--no-kernel", action="store_true",
                    help="packed-domain oracle instead of the fused scan "
                         "kernel")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels, the default) or cpu (their "
                         "plain versions)")
    ap.add_argument("--tier", choices=("q8", "f32"), default=None,
                    help="first-pass posting payload: int8-residual hot "
                         "tier + flash f32 re-rank (single-node default) "
                         "or f32. Fabric mode (--shards > 0) serves f32 "
                         "and REJECTS an explicit q8")
    ap.add_argument("--no-rerank", action="store_true",
                    help="q8 tier only: skip the flash-tier exact re-rank "
                         "and serve raw quantized distances")
    ap.add_argument("--rerank-round", type=int, default=64,
                    help="candidates exact-scored per re-rank round")
    ap.add_argument("--rerank-stable", type=int, default=1,
                    help="stop re-ranking after this many consecutive "
                         "rounds leave the top-k unchanged")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve through the sharded fabric with this many "
                         "shards (0 = single-node pipeline; see runbook "
                         "below)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fabric mode: replicas per cluster (R>=2 for "
                         "zero-loss failover)")
    ap.add_argument("--kill-shard-at", type=float, default=0.0,
                    help="fabric mode: kill a seeded-random live shard at "
                         "this many seconds into the trace (0 = no drill)")
    ap.add_argument("--trace-out", type=str, default="",
                    help="write a Chrome/Perfetto trace_event JSON here at "
                         "exit (enables tracing)")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="fraction of requests traced when --trace-out is "
                         "set (deterministic per-id sampling)")
    ap.add_argument("--metrics-every", type=float, default=0.0,
                    help="print the metrics registry every N seconds "
                         "(0 = only the end-of-run summary lines)")
    ap.add_argument("--health-out", type=str, default="",
                    help="atomically (re)write the health snapshot JSON "
                         "here")
    ap.add_argument("--health-every", type=float, default=0.0,
                    help="SLO tick + health snapshot cadence in seconds "
                         "(defaults to 1.0 when --health-out is set)")
    ap.add_argument("--shadow-rate", type=float, default=0.01,
                    help="fraction of queries shadow-audited against the "
                         "live corpus (0 disables the audit lane)")
    ap.add_argument("--no-quality", action="store_true",
                    help="disable the quality-observability layer")
    ap.add_argument("--harvest-out", type=str, default="",
                    help="write the per-query harvest ring as a "
                         "compressed npz shard here at exit")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.shards > 0:
        if args.rebuild:
            ap.error("--rebuild needs the single-node pipeline; the fabric "
                     "has no epoch-swap path yet (drop --shards)")
        if args.fail_shard >= 0:
            ap.error("--fail-shard is the single-node heartbeat simulation; "
                     "in fabric mode use --kill-shard-at for a live kill")
        return run_fabric(args)
    return run_single_node(args)


if __name__ == "__main__":
    main()
