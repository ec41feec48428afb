"""Sharded, replicated serving fabric (port of ``repro.distributed.fabric``)
— the multi-machine Helmsman tier.

The paper's production deployment spreads one logical index over ~40
machines and keeps serving through machine loss.  This module is that
fabric, scaled down to S simulated shard engines in one process:

* the posting tier is partitioned by **centroid ownership**
  (``storage.layout.plan_striping``): shard s owns the clusters striped to
  it, plus replica copies of hot clusters (``make_replica_map``, R=2);
* the router (:class:`ShardedFabric`) speaks the engine's
  ``plan / prefetch / dispatch / harvest`` stage protocol, so the
  :class:`~repro_torch.runtime.engine.ServeEngine` drives it unchanged:
  ``plan`` is the pipeline's centroid+LLSP planner on the fabric's device
  (the CUDA card by default), ``prefetch`` fans the micro-batch's
  probed-cluster union out to owner shards over per-shard SQ/CQ
  :class:`~repro_torch.runtime.engine.QueuePair` s, ``harvest`` collects
  per-shard candidate top-m sets and merges them on the device with the
  permutation-invariant ``merge_candidate_topk`` (Fig. 2a's frontend
  merge);
* each :class:`ShardNode` is a worker thread scanning ONLY its local
  posting subset with per-cluster-block numpy arithmetic — the same block
  produces bit-identical distances no matter which shard hosts it, which is
  what makes S=1 vs S=8 results *bit-equal*.  The scan stays numpy on the
  host, as in the reference: the same expression on every block is what
  the bit-equality rests on;
* robustness is live, not latent: shards heartbeat (between tasks and,
  unlike the reference, between the cluster blocks of a task) into the
  :class:`~repro_torch.distributed.fault.HeartbeatMonitor`; a dead shard
  (dead-letter CQ replies on a flushed kill, missed beats on a silent one)
  triggers ``plan_failover`` + ``ownership_mask`` re-routing, its in-flight
  tasks are **requeued** to surviving replicas, and its posting tier is
  retired through a per-shard :class:`~repro_torch.lifecycle.version.Epoch`
  (released only after its last outstanding task resolves);
* hot-shard load uses power-of-two-choices routing across live replicas,
  stragglers get deadline-aware hedged re-dispatch onto a less loaded
  replica, flaky shards get
  checksum-verified replies with a bounded per-task retry budget, and a
  cluster with no live replica degrades the touching queries to a
  ``partial`` response instead of erroring the batch.

Everything stochastic (fault schedules, victim choice) is seeded through
:class:`~repro_torch.distributed.fault.FaultInjector`, so a kill-a-shard
drill is replayable bit-for-bit.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.distance import merge_candidate_topk
from repro_torch.core.search import SearchConfig, _auto_ncand
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.fault import (
    FaultEvent, HeartbeatMonitor, ownership_mask, plan_failover,
)
from repro_torch.lifecycle.version import Epoch
from repro_torch.obs import Observability
from repro_torch.runtime.engine import QueuePair
from repro_torch.runtime.pipeline import (
    BatchResult, PrefetchPipeline, max_id_replicas,
)
from repro_torch.storage.host_tier import TieredPostings
from repro_torch.storage.layout import make_replica_map, plan_striping


HEDGE_WINDOW = 256      # task latencies the hedge threshold is taken over
HEDGE_MIN_SEEN = 32     # ... and how many it needs before it counts


@dataclasses.dataclass
class ShardTask:
    """One shard-scoped scan command (the SQ entry of the shard's queue
    pair).  ``cids`` are GLOBAL cluster ids this shard must scan for this
    micro-batch; ``probe`` is the per-query membership mask over them."""
    task_id: int
    shard: int
    queries: np.ndarray            # (bp, D) float32 — shared, not copied
    q2: np.ndarray                 # (bp, 1) float32 — precomputed ||q||^2
    cids: np.ndarray               # (U_s,) int64 global cluster ids
    probe: np.ndarray              # (bp, U_s) bool
    m: int                         # per-query candidate slots to return
    attempt: int = 0
    trace_ids: tuple = ()          # sampled request ids riding this task
    kind: str = "dispatch"         # "dispatch" | "requeue" | "hedge"


@dataclasses.dataclass
class ShardReply:
    """CQ entry from a shard.  status: "ok" | "dead".  ``checksum`` is the
    crc32 of the candidate payload computed BEFORE any in-transit
    corruption — the router re-hashes on receipt and retries a mismatch."""
    task_id: int
    shard: int
    status: str
    cand_d: Optional[np.ndarray] = None    # (bp, m) float32
    cand_i: Optional[np.ndarray] = None    # (bp, m) int32
    checksum: int = 0
    service_s: float = 0.0


def _payload_crc(cand_d: np.ndarray, cand_i: np.ndarray) -> int:
    return zlib.crc32(cand_i.tobytes(), zlib.crc32(cand_d.tobytes()))


class ShardNode:
    """One simulated shard engine: a worker thread draining its SQ.

    The scan is pure numpy, per cluster block: for each owned cluster the
    distances are ``||q||^2 - 2 q @ block.T + ||block||^2`` over the (L, D)
    block — identical inputs give identical bits regardless of which shard
    (or how many shards) the block lives on, so the cross-shard merge is
    bit-equal to the single-shard scan.  Nothing reaches the device from
    worker threads: the matmuls release the GIL, and S workers on one host
    time-share cleanly.  ``tier`` is a ``TieredPostings`` on the fabric's
    device (one CUDA stream each there) holding the host payload that the
    per-shard epoch releases.
    """

    def __init__(self, shard: int, postings: np.ndarray,
                 posting_ids: np.ndarray, owned: np.ndarray, fabric,
                 sq_depth: int = 256):
        self.shard = shard
        self.fabric = fabric
        self.owned = owned                           # (n_local,) global cids
        self.local_of = np.full(postings.shape[0], -1, np.int64)
        self.local_of[owned] = np.arange(owned.size)
        # tier-wrapped local subset: the per-shard Epoch releases exactly
        # this payload when the shard retires (the safe-retire machinery)
        self.tier = TieredPostings(
            np.ascontiguousarray(postings[owned]),
            np.ascontiguousarray(posting_ids[owned]),
            epoch=shard, device=fabric.device)
        self.qp = QueuePair(sq_depth=sq_depth)
        self.killed = False
        self.flush_on_kill = True
        self.stall_until = 0.0
        self.stall_s = 0.0
        self.corrupt_until = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        assert self._thread is None
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"shard-{self.shard}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def kill(self, flush: bool = True) -> None:
        """Die mid-traffic.  ``flush`` drains the SQ into dead-letter CQ
        replies (the NVMe abort path — the router requeues them at once);
        a silent kill just stops beating and lets the heartbeat monitor
        find the body."""
        self.flush_on_kill = flush
        self.killed = True
        self._stop.set()
        if flush:
            dead = [ShardReply(t.task_id, self.shard, "dead")
                    for t in self.qp.pop_submissions()]
            if dead:
                self.qp.complete(dead)
                self.fabric._reply_event.set()

    # -- worker ------------------------------------------------------------
    def _loop(self) -> None:
        clock = self.fabric.clock
        while not self._stop.is_set():
            tasks = self.qp.pop_submissions()
            if not tasks:
                if not self.killed:
                    self.fabric._beat(self.shard)
                self.qp.wait_submissions(timeout=self.fabric.idle_beat_s)
                continue
            for task in tasks:
                if self.killed:
                    if self.flush_on_kill:
                        self.qp.complete(
                            [ShardReply(task.task_id, self.shard, "dead")])
                        self.fabric._reply_event.set()
                    continue
                now = clock()
                if now < self.stall_until:
                    # straggle, but keep the heart beating with the inflated
                    # latency: a slow shard is a straggler (hedge target),
                    # not a corpse (failover target)
                    end = min(self.stall_until, now + self.stall_s)
                    while clock() < end and not self._stop.is_set():
                        self.fabric._beat(self.shard, latency=self.stall_s)
                        time.sleep(0.005)
                t0 = clock()
                cand_d, cand_i = self.scan(task, beat=self._alive)
                t1 = clock()
                service = t1 - t0
                obs = self.fabric.obs
                if obs.tracing and task.trace_ids:
                    # worker-side scan span: sequential per shard thread, so
                    # an "X" event on the shard's track is safe to nest
                    obs.trace.span(
                        "scan", t0, t1, trace_id=task.trace_ids[0],
                        track=f"shard-{self.shard}",
                        args={"task_id": task.task_id, "kind": task.kind,
                              "clusters": int(task.cids.size),
                              "trace_ids": list(task.trace_ids[:32])})
                crc = _payload_crc(cand_d, cand_i)
                if clock() < self.corrupt_until:
                    # bit flips in transit: payload mutates AFTER the
                    # checksum was taken, so the router's re-hash catches it
                    cand_i = np.where(cand_i >= 0, cand_i ^ 0x55, cand_i)
                if self.killed and not self.flush_on_kill:
                    continue               # died mid-scan, silently
                self.qp.complete([ShardReply(
                    task.task_id, self.shard, "ok", cand_d, cand_i,
                    checksum=crc, service_s=service)])
                self.fabric._beat(self.shard, latency=service)
                self.fabric._note_service(self.shard, service)
                self.fabric._reply_event.set()

    def _alive(self) -> None:
        """Beat from inside a scan: a shard busy on a long task is alive.
        The reference beats only between tasks, so a task that scans for
        longer than the heartbeat's miss window (3 ticks of 20 ms in the
        serving drill, shorter than one batch of 32 over a 100k corpus on
        one shard) reads as a dead shard there."""
        if not self.killed:
            self.fabric._beat(self.shard)

    # -- the scan itself ---------------------------------------------------
    def scan(self, task: ShardTask, beat=None
             ) -> tuple[np.ndarray, np.ndarray]:
        """Per-cluster-block scan -> per-query top-m candidate (d, id) sets.

        Blocks are visited in ascending global-cluster order and reduced
        with the identical (bp, L) expression everywhere, so the candidate
        VALUES are layout-independent; only the top-m cut varies, and m is
        sized (k2 * dup_bound) so the global top-k distinct ids always
        survive the per-shard cut (same bound as the pipeline's oracle).
        ``beat`` (the worker's :meth:`_alive`) is called before each
        block."""
        postings, pids = self.tier.postings, self.tier.posting_ids
        if postings is None:
            raise RuntimeError(f"scan on retired shard {self.shard}")
        bp = task.queries.shape[0]
        l = postings.shape[1]
        cols = []
        ids_cols = []
        for j, cid in enumerate(task.cids):
            if beat is not None:
                beat()                                   # one a block
            loc = self.local_of[cid]
            block = postings[loc]                        # (L, D)
            ids = pids[loc]                              # (L,)
            n2 = np.einsum("ld,ld->l", block, block)
            d = task.q2 - 2.0 * (task.queries @ block.T) + n2[None, :]
            dead = ~task.probe[:, j : j + 1] | (ids < 0)[None, :]
            cols.append(np.where(dead, np.inf, np.maximum(d, 0.0)))
            ids_cols.append(ids)
        if not cols:
            return (np.full((bp, task.m), np.inf, np.float32),
                    np.full((bp, task.m), -1, np.int32))
        d = np.concatenate(cols, axis=1).astype(np.float32, copy=False)
        flat_ids = np.concatenate(ids_cols).astype(np.int32, copy=False)
        n = d.shape[1]
        m = min(task.m, n)
        if m < n:
            part = np.argpartition(d, m - 1, axis=1)[:, :m]
            pd = np.take_along_axis(d, part, axis=1)
        else:
            part = np.broadcast_to(np.arange(n), (bp, n))
            pd = d
        order = np.argsort(pd, axis=1, kind="stable")
        cand_d = np.take_along_axis(pd, order, axis=1)
        cand_i = flat_ids[np.take_along_axis(part, order, axis=1)]
        cand_i = np.where(np.isinf(cand_d), -1, cand_i)
        if m < task.m:                                   # tiny shard: pad
            padw = task.m - m
            cand_d = np.pad(cand_d, ((0, 0), (0, padw)),
                            constant_values=np.inf)
            cand_i = np.pad(cand_i, ((0, 0), (0, padw)), constant_values=-1)
        return np.ascontiguousarray(cand_d), np.ascontiguousarray(cand_i)


@dataclasses.dataclass
class _TaskRecord:
    """Router-side bookkeeping for one outstanding ShardTask."""
    task: ShardTask
    state: "_FabricBatch"
    sent_at: float
    hedged: bool = False


class _FabricBatch:
    """Harvest-side state of one micro-batch in the fabric."""

    def __init__(self, plan, queries: np.ndarray, q2: np.ndarray,
                 wanted: np.ndarray, probe_u: np.ndarray,
                 deadline: Optional[float]):
        self.plan = plan
        self.queries = queries
        self.q2 = q2
        self.wanted = wanted                 # (U,) union cluster ids
        self.probe_u = probe_u               # (bp, U) bool
        self.deadline = deadline
        self.pending: set = set(int(c) for c in wanted)
        self.lost: set = set()
        # lint: bounded-by(per-request accumulator, one entry per shard)
        self.cand: list = []                 # [(cand_d, cand_i)]
        self.dispatched_at = 0.0

    def resolve(self, cids, lost: bool = False) -> list:
        """Mark clusters resolved; returns the ones that were still
        pending (late duplicate replies resolve nothing)."""
        fresh = [int(c) for c in cids if int(c) in self.pending]
        for c in fresh:
            self.pending.discard(c)
            if lost:
                self.lost.add(c)
        return fresh

    @property
    def complete(self) -> bool:
        return not self.pending

    def partial_rows(self) -> np.ndarray:
        """(bp,) bool — queries whose probe set touched a lost cluster."""
        if not self.lost:
            return np.zeros(self.probe_u.shape[0], bool)
        cols = np.isin(self.wanted, np.fromiter(self.lost, np.int64,
                                                len(self.lost)))
        return self.probe_u[:, cols].any(axis=1)


@dataclasses.dataclass
class FabricStats:
    tasks: int = 0
    replies: int = 0
    dead_replies: int = 0
    hedges: int = 0
    retries: int = 0
    checksum_failures: int = 0
    requeued_tasks: int = 0
    timeouts: int = 0
    partial_queries: int = 0
    # lint: bounded-by(one entry per shard; _declare_failed de-dups)
    failovers: list = dataclasses.field(default_factory=list)
    # per-shard accumulators (measured on the worker, summed by the router)
    busy_s: Optional[np.ndarray] = None      # (S,) scan seconds per shard
    tasks_per_shard: Optional[np.ndarray] = None

    def init(self, n_shards: int) -> None:
        self.busy_s = np.zeros(n_shards)
        self.tasks_per_shard = np.zeros(n_shards, np.int64)


class ShardedFabric:
    """S-shard serving fabric behind the engine's stage protocol.

    ``plan`` (and ``route``) run on the pipeline's planner on ``device``
    (the CUDA card by default; ``"cpu"`` runs the plain versions) — one
    centroid+LLSP pass for the whole batch, no per-shard replanning.
    ``prefetch`` is the fan-out: the batch's probed-cluster union is
    deduped once, each union cluster is assigned to ONE live shard by
    power-of-two-choices over its replicas, and one ShardTask per owner
    shard is submitted to that shard's SQ (epoch-ref'd). ``harvest`` pumps
    every shard's CQ (replies for ANY in-flight batch route through the
    outstanding table, so deep engine windows work), verifies checksums,
    drives the heartbeat / failover / hedge / retry machinery, and merges
    the surviving candidate sets with ``merge_candidate_topk`` on
    ``device``. The index's postings are copied to host numpy once, here.
    """

    accepts_deadline = True

    def __init__(self, index, llsp_params, cfg: SearchConfig, *,
                 n_shards: int = 4, n_replicas: int = 2,
                 hot_clusters: Optional[np.ndarray] = None,
                 pad_batch: int = 16, clock=time.monotonic,
                 hedge_after_s: float = 0.08, retry_budget: int = 3,
                 harvest_timeout_s: float = 5.0, tick_s: float = 0.05,
                 miss_threshold: int = 3, idle_beat_s: float = 0.01,
                 injector=None, name: str = "fabric",
                 obs: Optional[Observability] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.index = index
        self.cfg = cfg
        self.clock = clock
        self.name = name
        self.obs = obs if obs is not None else Observability.off()
        m = self.obs.metrics
        self._m_requeued = m.counter("fabric.requeued")   # by cause
        self._m_hedges = m.counter("fabric.hedges")
        self._m_retries = m.counter("fabric.retries")     # by cause
        self._m_timeouts = m.counter("fabric.timeouts")
        self._m_partial = m.counter("fabric.partial_queries")  # by reason
        self._m_failovers = m.counter("fabric.failovers")
        self._g_qdepth = m.gauge("fabric.shard_queue_depth")
        self._g_out = m.gauge("fabric.shard_outstanding")
        self._h_task = m.histogram("fabric.task_service_s")
        self.n_shards = int(n_shards)
        self.hedge_after_s = hedge_after_s
        # the latencies (submit -> reply) of the last tasks answered: the
        # hedge threshold is at least their 95th percentile
        self._latencies: collections.deque = collections.deque(
            maxlen=HEDGE_WINDOW)
        self.retry_budget = int(retry_budget)
        self.harvest_timeout_s = harvest_timeout_s
        self.tick_s = tick_s
        self.idle_beat_s = idle_beat_s
        self.injector = injector
        # planner: the pipeline in plan/route-only duty (tier-less, so it is
        # never dispatched — the shards scan, the planner routes)
        self.planner = PrefetchPipeline(index, llsp_params, cfg, tier=None,
                                        pad_batch=pad_batch,
                                        device=self.device)
        postings = np.ascontiguousarray(
            index.postings.cpu().numpy(), np.float32)
        posting_ids = np.ascontiguousarray(
            index.posting_ids.cpu().numpy(), np.int32)
        n_clusters = postings.shape[0]
        self.striping = plan_striping(n_clusters, self.n_shards)
        self.rmap0 = make_replica_map(n_clusters, self.n_shards,
                                      self.striping,
                                      hot_clusters=hot_clusters,
                                      n_replicas=n_replicas)
        self.live_replicas = self.rmap0.replicas.copy()
        self.owner = self.live_replicas[:, 0].copy()
        self.owner_mask = ownership_mask(self.owner, self.n_shards)
        self.failed: set = set()
        self.lost: set = set()
        self.hb = HeartbeatMonitor(self.n_shards,
                                   miss_threshold=miss_threshold)
        self._hb_lock = threading.Lock()
        self._svc_lock = threading.Lock()
        self._last_tick = clock()
        self._reply_event = threading.Event()
        self.stats = FabricStats()
        self.stats.init(self.n_shards)
        # lint: bounded-by(one node/epoch per shard, fixed at deploy)
        self.nodes = []
        # lint: bounded-by(one node/epoch per shard, fixed at deploy)
        self.epochs = []
        for s in range(self.n_shards):
            owned = np.nonzero((self.rmap0.replicas == s).any(axis=1))[0]
            node = ShardNode(s, postings, posting_ids, owned, self)
            self.nodes.append(node)
            self.epochs.append(Epoch(f"{name}/shard{s}", s, node,
                                     clock=clock))
        self._outstanding: dict[int, _TaskRecord] = {}
        self._out_per_shard = np.zeros(self.n_shards, np.int64)
        self._task_ids = iter(range(1, 1 << 62))
        k2 = cfg.n_cand or _auto_ncand(cfg.k)
        self.dup_bound = max_id_replicas(posting_ids)
        self.cand_m = k2 * self.dup_bound
        self.cand_bucket = 256
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        for node in self.nodes:
            node.start()
        with self._hb_lock:
            for s in range(self.n_shards):
                self.hb.beat(s)
        self._started = True

    def stop(self) -> None:
        for node in self.nodes:
            node.stop()
        self._started = False

    def close(self) -> None:
        """Stop the workers and the planner's threads (idempotent)."""
        self.stop()
        self.planner.close()

    def alive_shards(self) -> list[int]:
        return [s for s in range(self.n_shards)
                if s not in self.failed and not self.nodes[s].killed]

    # -- worker-side callbacks (thread-safe) -------------------------------
    def _beat(self, shard: int, latency: float = 0.001) -> None:
        with self._hb_lock:
            self.hb.beat(shard, latency=latency)

    def _note_service(self, shard: int, service_s: float) -> None:
        with self._svc_lock:
            self.stats.busy_s[shard] += service_s
            self.stats.tasks_per_shard[shard] += 1

    # -- fault injection (FaultInjector.poll target) -----------------------
    def inject(self, ev: FaultEvent, shard: int) -> None:
        node = self.nodes[shard]
        now = self.clock()
        if ev.kind == "kill":
            node.kill(flush=not ev.silent)
        elif ev.kind == "stall":
            node.stall_until = now + ev.duration_s
            node.stall_s = max(ev.stall_s, 1e-3)
        elif ev.kind == "corrupt":
            node.corrupt_until = now + ev.duration_s
        else:
            raise ValueError(f"unknown fault kind {ev.kind!r}")

    # -- stage protocol ----------------------------------------------------
    @property
    def pad_batch(self) -> int:
        return self.planner.pad_batch

    def route(self, queries, topk):
        return self.planner.route(queries, topk)

    def plan(self, queries, topk, nprobe_cap=None, routed=None,
             deadline: Optional[float] = None):
        plan = self.planner.plan(queries, topk, nprobe_cap=nprobe_cap,
                                 routed=routed)
        plan.deadline = deadline           # carried to harvest (hedging &
        return plan                        # give-up are deadline-aware)

    def _p2c_assign(self, wanted: np.ndarray
                    ) -> tuple[dict[int, list[int]], list[int]]:
        """Assign each union cluster to one live shard: power-of-two-choices
        over its live replicas by instantaneous load (SQ depth + outstanding
        tasks), ties to the lower shard id.  Returns ({shard: [cid]},
        [lost cid])."""
        depths = np.array([self.nodes[s].qp.sq_len() for s
                           in range(self.n_shards)])
        load = depths + self._out_per_shard
        for s in range(self.n_shards):
            # the instantaneous load signal p2c routes on, surfaced as
            # per-shard gauges (the "is shard 3's SQ the p99?" question)
            self._g_qdepth.set(int(depths[s]), f"shard{s}")
            self._g_out.set(int(self._out_per_shard[s]), f"shard{s}")
        by_shard: dict[int, list[int]] = {}
        lost: list[int] = []
        for c in wanted:
            reps = [int(r) for r in self.live_replicas[c] if r >= 0
                    and r not in self.failed]
            if not reps:
                lost.append(int(c))
                continue
            best = min(reps[:2], key=lambda s: (load[s], s))
            by_shard.setdefault(best, []).append(int(c))
            load[best] += 1
        return by_shard, lost

    def _submit(self, state: _FabricBatch, shard: int, cids: list[int],
                attempt: int = 0, kind: str = "dispatch") -> None:
        cols = np.searchsorted(state.wanted, np.asarray(cids, np.int64))
        task = ShardTask(
            task_id=next(self._task_ids), shard=shard,
            queries=state.queries, q2=state.q2,
            cids=np.asarray(cids, np.int64),
            probe=np.ascontiguousarray(state.probe_u[:, cols]),
            m=self.cand_m, attempt=attempt,
            trace_ids=getattr(state.plan, "trace_ids", ()), kind=kind)
        self.epochs[shard].acquire()
        sent = self.clock()
        self._outstanding[task.task_id] = _TaskRecord(task, state,
                                                      sent_at=sent)
        self._out_per_shard[shard] += 1
        self.stats.tasks += 1
        if self.obs.tracing and task.trace_ids:
            # task LIFETIME (submit -> resolve): tasks overlap on a shard's
            # track while queued, so async "b"/"e" — closed by the single
            # drop point, _drop_outstanding
            self.obs.trace.abegin(
                "task", f"task-{task.task_id}", t=sent,
                trace_id=task.trace_ids[0], track=f"shard-{shard}",
                args={"kind": kind, "attempt": attempt,
                      "clusters": len(cids),
                      "trace_ids": list(task.trace_ids[:32])})
            # flow arrow request -> shard task: the "s" endpoint binds near
            # the request's async span on the requests track, the "f"
            # endpoint lands on the shard task it fanned out to — Perfetto
            # draws the arrow, check_well_nested verifies the pairing
            fid = f"flow-task-{task.task_id}"
            self.obs.trace.flow_start(
                "fanout", fid, t=sent, trace_id=task.trace_ids[0],
                track="requests", args={"shard": shard, "kind": kind})
            self.obs.trace.flow_finish(
                "fanout", fid, t=sent, trace_id=task.trace_ids[0],
                track=f"shard-{shard}")
        if not self.nodes[shard].qp.submit(task, block=False):
            # shard SQ full — treat as an instant dead-letter and requeue
            self._drop_outstanding(task.task_id)
            self._reroute(state, cids, attempt + 1, cause="sq_full")

    def prefetch(self, plan) -> _FabricBatch:
        """Fan-out: dedupe the batch's probed-cluster union, assign owners,
        submit one ShardTask per owner shard."""
        t = plan.times
        t.gather_start = self.clock()
        if self.injector is not None:
            self.injector.poll(self.clock(), self)
        queries = np.ascontiguousarray(plan.queries_host, np.float32)
        q2 = np.einsum("bd,bd->b", queries, queries)[:, None]
        live = plan.pmask & (plan.cids >= 0)
        wanted = np.unique(plan.cids[live]).astype(np.int64)
        # (bp, U) probe-membership: columns follow sorted union order
        bp, p = plan.cids.shape
        probe_u = np.zeros((bp, wanted.size), bool)
        if wanted.size:
            cols = np.searchsorted(wanted, plan.cids[live])
            rows = np.nonzero(live)[0]
            probe_u[rows, cols] = True
        state = _FabricBatch(plan, queries, q2, wanted, probe_u,
                             getattr(plan, "deadline", None))
        by_shard, lost = self._p2c_assign(wanted)
        state.resolve(lost, lost=True)
        for shard, cids in sorted(by_shard.items()):
            self._submit(state, shard, cids)
        t.gather_end = self.clock()
        t.stream_end = t.gather_end
        t.clusters_requested = int(live.sum())
        t.union_clusters = int(wanted.size)
        return state

    def dispatch(self, state: _FabricBatch) -> _FabricBatch:
        state.plan.times.scan_dispatch = self.clock()
        state.dispatched_at = state.plan.times.scan_dispatch
        return state

    # -- failure machinery -------------------------------------------------
    def _drop_outstanding(self, task_id: int) -> Optional[_TaskRecord]:
        rec = self._outstanding.pop(task_id, None)
        if rec is not None:
            self.epochs[rec.task.shard].release()
            self._out_per_shard[rec.task.shard] -= 1
            if self.obs.tracing and rec.task.trace_ids:
                self.obs.trace.aend("task", f"task-{task_id}",
                                    track=f"shard-{rec.task.shard}")
        return rec

    def _reroute(self, state: _FabricBatch, cids, attempt: int,
                 cause: str = "requeue") -> None:
        """Re-dispatch unresolved clusters under the current live replica
        map; clusters past the retry budget (or with no live replica) are
        lost -> the touching queries degrade to partial.  ``cause`` labels
        the requeue counter ("sq_full" | "dead_reply" | "checksum" |
        "failover")."""
        todo = [c for c in cids if c in state.pending]
        if not todo:
            return
        if attempt > self.retry_budget:
            state.resolve(todo, lost=True)
            return
        by_shard, lost = self._p2c_assign(np.asarray(todo, np.int64))
        state.resolve(lost, lost=True)
        for shard, group in sorted(by_shard.items()):
            self._submit(state, shard, group, attempt=attempt,
                         kind="requeue")
            self.stats.requeued_tasks += 1
            self._m_requeued.inc(1, cause)

    def _declare_failed(self, shard: int) -> None:
        """Shard is dead: recompute the failover plan from the seed
        machinery, retire its epoch, and requeue everything it still owed."""
        if shard in self.failed:
            return
        self.failed.add(shard)
        fo = plan_failover(self.rmap0, sorted(self.failed))
        self.owner = fo.owner
        self.owner_mask = ownership_mask(fo.owner, self.n_shards)
        self.live_replicas = self.rmap0.failover(sorted(self.failed)).replicas
        self.lost = set(int(c) for c in fo.lost)
        self.stats.failovers.append({
            "t": self.clock(), "shard": shard,
            "moved": int(fo.moved.size), "lost": int(fo.n_lost)})
        self._m_failovers.inc(1, f"shard{shard}")
        if self.obs.tracing:
            self.obs.trace.instant(
                "failover", track="router",
                args={"shard": shard, "moved": int(fo.moved.size),
                      "lost": int(fo.n_lost)})
        self.epochs[shard].retire()
        orphans = [tid for tid, rec in self._outstanding.items()
                   if rec.task.shard == shard]
        for tid in orphans:
            rec = self._drop_outstanding(tid)
            self._reroute(rec.state, rec.task.cids.tolist(),
                          rec.task.attempt + 1, cause="failover")

    def _maybe_tick(self) -> None:
        """Advance the heartbeat logical clock at tick_s cadence; shards
        past miss_threshold ticks without a beat are declared failed."""
        now = self.clock()
        if now - self._last_tick < self.tick_s:
            return
        with self._hb_lock:
            # one tick per cadence check, never a catch-up burst: a long gap
            # between harvest calls (jit warmup, idle engine) must not burn
            # miss_threshold ticks at once and fail every healthy shard
            self.hb.tick()
            self._last_tick = now
            newly = [int(s) for s in self.hb.failed()
                     if s not in self.failed]
        for s in newly:
            self._declare_failed(s)

    def _pump_replies(self) -> int:
        """Drain every shard CQ; route replies through the outstanding
        table to their batch state.  Returns replies consumed."""
        n = 0
        for node in self.nodes:
            for reply in node.qp.poll():
                n += 1
                rec = self._drop_outstanding(reply.task_id)
                if rec is None:
                    continue               # hedge-resolved or abandoned
                self.stats.replies += 1
                if reply.status == "dead":
                    self.stats.dead_replies += 1
                    self._m_retries.inc(1, "dead_reply")
                    self._declare_failed(reply.shard)
                    self._reroute(rec.state, rec.task.cids.tolist(),
                                  rec.task.attempt + 1, cause="dead_reply")
                    continue
                if _payload_crc(reply.cand_d, reply.cand_i) != reply.checksum:
                    self.stats.checksum_failures += 1
                    self.stats.retries += 1
                    self._m_retries.inc(1, "checksum")
                    if self.obs.tracing and rec.task.trace_ids:
                        self.obs.trace.instant(
                            "checksum_retry", track="router",
                            trace_id=rec.task.trace_ids[0],
                            args={"shard": reply.shard,
                                  "task_id": reply.task_id})
                    self._reroute(rec.state, rec.task.cids.tolist(),
                                  rec.task.attempt + 1, cause="checksum")
                    continue
                self._h_task.observe(reply.service_s)
                self._latencies.append(self.clock() - rec.sent_at)
                fresh = rec.state.resolve(rec.task.cids.tolist())
                if fresh:
                    rec.state.cand.append((reply.cand_d, reply.cand_i))
        return n

    def _hedge_due(self, state: _FabricBatch) -> None:
        """Deadline-aware hedged re-dispatch: an outstanding task older than
        the hedge threshold (or whose batch deadline is at risk) gets its
        unresolved clusters duplicated onto alternate live replicas; the
        first reply to land resolves the clusters, the loser is ignored.

        Unlike the reference, the threshold is at least the 95th percentile
        of the last ``HEDGE_WINDOW`` task latencies once ``HEDGE_MIN_SEEN``
        have been seen, a hedge goes only to a replica with fewer
        outstanding tasks than the straggler's shard, and a hedge is never
        hedged again.  Under a closed loop every task waits in a queue
        longer than ``hedge_after_s``: the reference's rule then copies a
        large share of the tasks onto shards as loaded as their own, and
        the copies pile onto one replica pair until batches wait past the
        give-up."""
        now = self.clock()
        thresh = self.hedge_after_s
        if len(self._latencies) >= HEDGE_MIN_SEEN:
            thresh = max(thresh, float(np.percentile(self._latencies, 95)))
        if state.deadline is not None:
            thresh = min(thresh, max((state.deadline - now) * 0.5, 0.01))
        for tid, rec in list(self._outstanding.items()):
            if rec.state is not state or rec.hedged \
                    or rec.task.kind == "hedge":
                continue
            if now - rec.sent_at < thresh:
                continue
            todo = [c for c in rec.task.cids.tolist() if c in state.pending]
            if not todo:
                continue
            by_shard: dict[int, list[int]] = {}
            slow = rec.task.shard
            for c in todo:
                alts = [int(r) for r in self.live_replicas[c]
                        if r >= 0 and r != slow and r not in self.failed
                        and self._out_per_shard[r] < self._out_per_shard[slow]]
                if alts:
                    by_shard.setdefault(alts[0], []).append(c)
            if not by_shard:
                continue
            rec.hedged = True
            if self.obs.tracing and rec.task.trace_ids:
                self.obs.trace.instant(
                    "hedge", track="router",
                    trace_id=rec.task.trace_ids[0],
                    args={"slow_shard": rec.task.shard,
                          "task_id": tid,
                          "age_ms": round((now - rec.sent_at) * 1e3, 3)})
            for shard, group in sorted(by_shard.items()):
                self._submit(state, shard, group,
                             attempt=rec.task.attempt, kind="hedge")
                self.stats.hedges += 1
                self._m_hedges.inc(1, f"shard{shard}")

    def harvest(self, state: _FabricBatch) -> BatchResult:
        """Collect this batch's replies (pumping every in-flight batch's),
        drive failure detection, merge, and stamp partial rows."""
        t = state.plan.times
        give_up = state.dispatched_at + self.harvest_timeout_s
        if state.deadline is not None:
            give_up = max(give_up, state.deadline)
        timed_out = False
        while not state.complete:
            if self.injector is not None:
                self.injector.poll(self.clock(), self)
            got = self._pump_replies()
            self._maybe_tick()
            if state.complete:
                break
            if self.clock() >= give_up:
                # bound the wait: whatever is still unresolved is lost and
                # the touching queries degrade to partial — a zero-drop
                # fabric never hangs a batch on a black-holed shard
                self.stats.timeouts += 1
                self._m_timeouts.inc()
                timed_out = True
                if self.obs.tracing:
                    self.obs.trace.instant(
                        "give_up", track="router",
                        args={"unresolved": len(state.pending)})
                state.resolve(list(state.pending), lost=True)
                break
            self._hedge_due(state)
            if not got:
                self._reply_event.wait(timeout=0.002)
                self._reply_event.clear()
        tids = getattr(state.plan, "trace_ids", ())
        m0 = self.clock() if (self.obs.tracing and tids) else 0.0
        ids, dists = self._merge(state)
        t.scan_done = self.clock()
        if m0:
            # harvest runs sequentially on the poller thread, so merges on
            # the router track never overlap — an "X" span is safe
            self.obs.trace.span(
                "merge", m0, t.scan_done, trace_id=tids[0], track="router",
                args={"shard_sets": len(state.cand),
                      "trace_ids": list(tids[:32])})
        b = t.size
        partial = state.partial_rows()[:b].copy()
        partial_reason = "timeout" if timed_out else "no_replica"
        n_partial = int(partial.sum())
        self.stats.partial_queries += n_partial
        if n_partial:
            self._m_partial.inc(n_partial, partial_reason)
        return BatchResult(
            ids=ids[:b], dists=dists[:b],
            nprobe=state.plan.nprobe[:b].copy(), times=t,
            partial=partial, partial_reason=partial_reason,
            quality=self._coverage(state, b),
            shards=self._primary_shards(state, b))

    def _coverage(self, state: _FabricBatch, b: int) -> np.ndarray:
        """(b,) per-query COVERAGE proxy: the rank-weighted fraction of
        this query's probed clusters a live replica actually scanned —
        1.0 on complete rows, < 1.0 exactly on the partial rows whose
        recall is at risk.  Probe rank j carries weight ``1/(1+j)``: the
        router orders ``plan.cids`` by expected yield (nearest centroid
        first — the cluster most of the true neighbors live in), so losing
        a query's rank-0 probe costs far more recall than losing its
        rank-15 probe, and the proxy must say so.  Under round-robin
        striping an unweighted count cannot separate a dead shard's home
        queries (they lose rank 0) from bystanders (they lose ~1/S of the
        tail) — every query loses the same 1/S of its probes.  This is
        the fabric's stand-in for the pipeline's rerank-agreement proxy
        (the shards return exact f32 distances, so agreement would be
        trivially 1.0)."""
        cids = np.asarray(state.plan.cids[:b], np.int64)
        valid = cids >= 0
        w = 1.0 / (1.0 + np.arange(cids.shape[1], dtype=np.float32))
        tot = (valid * w).sum(axis=1)
        lost_w = np.zeros(b, np.float32)
        if state.lost:
            lost = np.isin(cids, np.fromiter(
                state.lost, np.int64, len(state.lost))) & valid
            lost_w = (lost * w).sum(axis=1).astype(np.float32)
        cov = 1.0 - lost_w / np.maximum(tot, 1e-9)
        return cov.astype(np.float32)

    def _primary_shards(self, state: _FabricBatch, b: int) -> np.ndarray:
        """(b,) primary shard of each query's nearest probed cluster —
        the label the quality monitor buckets per-shard proxy histograms
        by (the kill drill's 'did the victim's queries dip?' view)."""
        c0 = np.asarray(state.plan.cids[:b, 0], np.int64)
        return self.striping.shard_of(np.maximum(c0, 0)).astype(np.int32)

    def _merge(self, state: _FabricBatch) -> tuple[np.ndarray, np.ndarray]:
        """Cross-shard merge: concatenate every shard's candidate set and
        run the permutation-invariant ``merge_candidate_topk`` on the
        fabric's device — dedup by id, ascending, (inf, -1) invalid slots.
        Width is bucketed (``cand_bucket``), as in the reference, so the
        merge sees a bounded set of shapes under varying shard fan-outs."""
        bp = state.queries.shape[0]
        k = self.cfg.k
        if not state.cand:
            return (np.full((bp, k), -1, np.int32),
                    np.full((bp, k), np.inf, np.float32))
        cd = np.concatenate([c[0] for c in state.cand], axis=1)
        ci = np.concatenate([c[1] for c in state.cand], axis=1)
        n = cd.shape[1]
        width = -(-max(n, k) // self.cand_bucket) * self.cand_bucket
        if width != n:
            cd = np.pad(cd, ((0, 0), (0, width - n)),
                        constant_values=np.inf)
            ci = np.pad(ci, ((0, 0), (0, width - n)), constant_values=-1)
        vals, out_ids = merge_candidate_topk(
            torch.from_numpy(np.ascontiguousarray(cd)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(ci)).to(self.device), k)
        return out_ids.cpu().numpy(), vals.cpu().numpy()

    # -- synchronous / helper paths ---------------------------------------
    def scan_sync(self, queries, topk) -> BatchResult:
        """Thread-free end-to-end scan: fan out by PRIMARY owner, scan each
        shard's slice inline, merge.  The property tests' deterministic
        path (no p2c load dependence, no worker scheduling)."""
        plan = self.plan(queries, topk)
        t = plan.times
        qs = np.ascontiguousarray(plan.queries_host, np.float32)
        q2 = np.einsum("bd,bd->b", qs, qs)[:, None]
        live = plan.pmask & (plan.cids >= 0)
        wanted = np.unique(plan.cids[live]).astype(np.int64)
        bp = qs.shape[0]
        probe_u = np.zeros((bp, wanted.size), bool)
        if wanted.size:
            cols = np.searchsorted(wanted, plan.cids[live])
            probe_u[np.nonzero(live)[0], cols] = True
        state = _FabricBatch(plan, qs, q2, wanted, probe_u, None)
        for s in range(self.n_shards):
            cids = [int(c) for c in wanted if self.owner[c] == s]
            if not cids:
                continue
            cols = np.searchsorted(wanted, np.asarray(cids, np.int64))
            task = ShardTask(0, s, qs, q2, np.asarray(cids, np.int64),
                             np.ascontiguousarray(probe_u[:, cols]),
                             m=self.cand_m)
            state.cand.append(self.nodes[s].scan(task))
            state.resolve(cids)
        state.resolve(list(state.pending), lost=True)
        ids, dists = self._merge(state)
        t.scan_dispatch = t.gather_start = t.gather_end = t.stream_end \
            = t.plan_end
        t.scan_done = self.clock()
        b = t.size
        return BatchResult(ids=ids[:b], dists=dists[:b],
                           nprobe=plan.nprobe[:b].copy(), times=t,
                           partial=state.partial_rows()[:b].copy())

    def query_shards(self, queries) -> np.ndarray:
        """(B,) primary shard of each query's nearest centroid — how the
        drills find a hot shard's query rows."""
        cids, _ = self.planner.route(np.asarray(queries, np.float32),
                                     self.cfg.k)
        return self.striping.shard_of(cids[:, 0].astype(np.int64))

    def warmup(self, batch_sizes=(16, 32)) -> int:
        """Run the plan and the merge once at the shapes live traffic will
        hit (kernel library, allocator growth; the shard scans are numpy —
        nothing to warm).  Returns the number of warm calls."""
        n = 0
        dim = int(self.index.centroids.shape[1])
        for b in batch_sizes:
            bp = -(-b // self.pad_batch) * self.pad_batch
            q = np.zeros((bp, dim), np.float32)
            self.planner.route(q, self.cfg.k)
            n += 1
        for w in range(1, 1 + self.n_shards):
            width = -(-w * self.cand_m // self.cand_bucket) \
                * self.cand_bucket
            merge_candidate_topk(
                torch.full((self.pad_batch, width), float("inf"),
                           dtype=torch.float32, device=self.device),
                torch.full((self.pad_batch, width), -1, dtype=torch.int32,
                           device=self.device),
                self.cfg.k)
            n += 1
        return n
