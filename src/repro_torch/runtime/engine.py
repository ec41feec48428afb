"""Queue-pair serving engine — the userspace SQ/CQ stack of §4.1, on host.

The paper replaces the kernel block stack with userspace submission /
completion queue pairs: producers append commands to a bounded SQ, ring a
doorbell, and a polling thread drains completions without syscalls or
per-request wakeups.  The device-serving analogue implemented here:

* :class:`QueuePair` — a bounded submission queue of :class:`SearchRequest`
  plus a completion queue of :class:`Completion`.  ``submit`` is the
  doorbell (condition notify); a full SQ is back-pressure and fails fast
  (or blocks, caller's choice) instead of growing an unbounded backlog.
* :class:`ServeEngine` — the poller: drains the SQ into the
  :class:`~repro_torch.runtime.batcher.DynamicBatcher`, releases micro-batches
  into a :class:`~repro_torch.runtime.pipeline.PrefetchPipeline`, and pushes
  completions.  Its serving loop keeps one batch *scanning on device* while
  the next batch is *planned and its clusters gathered on host* — the
  prefetch-overlap that makes streamed serving bandwidth-bound instead of
  latency-bound (measured, not asserted: see StageTimes/overlap_efficiency
  in runtime/pipeline.py).

Determinism: everything time-dependent takes an injectable ``clock``; tests
drive :meth:`ServeEngine.step` with a virtual clock, the daemon uses
:meth:`ServeEngine.start`'s real poller thread.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.obs import Observability
from repro_torch.runtime.pipeline import stage_spans


@dataclasses.dataclass
class RoutePlan:
    """Admission-time probe routing for one request (§4.3-compatible: only
    pre-search features — the centroid scan + LLSP level decision the plan
    stage would run anyway, computed once when the request leaves the SQ).

    ``probe_set`` is the locality signature the batcher groups on;
    ``source`` tags the pipeline whose centroids produced the route, so a
    batch formed after an epoch swap detects the stale route and replans
    instead of scanning the new index with the old cluster ids."""
    cids: np.ndarray                # (P,) int32 probed clusters, -1 padded
    nprobe: int
    probe_set: frozenset            # {cluster id} — the grouping signature
    source: object                  # pipeline that routed (staleness tag)
    bits: Optional[np.ndarray] = None   # (max probed id + 1,) bool cache,
                                        # built lazily by the batcher so
                                        # formation never redoes the
                                        # set -> bitset conversion per pool


@dataclasses.dataclass
class SearchRequest:
    """One query submitted to the SQ (the paper's NVMe-command analogue)."""
    req_id: int
    index: str
    query: np.ndarray               # (D,) float32
    topk: int
    deadline: Optional[float]       # absolute clock time, None = best-effort
    arrival: float = 0.0
    route: Optional[RoutePlan] = None   # set by the poller at SQ drain
    trace_id: int = 0               # obs identity minted at submit
                                    # (0 = unsampled/untraced)


@dataclasses.dataclass
class Completion:
    """CQ entry.  status: "ok" | "degraded" | "shed" | "partial" | "failed".

    "partial": answered from an incomplete shard set (the fabric's
    graceful-degrade path — ids/dists are valid but may miss candidates
    from lost clusters).  "failed": the serving path itself errored; the
    request is completed (never abandoned) with no payload.

    ``reason`` says WHY for every non-"ok" status ("deadline", "drain",
    "no_replica", "timeout", "plan_error", "prefetch_error",
    "dispatch_error", "harvest_error", "crash_drain") — the label the
    shed/degrade/partial counters break down by.  New fields are appended
    with defaults so positional construction stays valid."""
    req_id: int
    index: str
    status: str
    ids: Optional[np.ndarray]       # (k,) int32 (None when shed)
    dists: Optional[np.ndarray]     # (k,) float32
    nprobe: int
    submitted: float
    completed: float
    reason: str = ""                # why, for every non-"ok" status
    trace_id: int = 0
    quality: float = -1.0           # per-query recall proxy (rerank
                                    # agreement / fabric coverage);
                                    # -1 = the path produced no proxy

    @property
    def latency(self) -> float:
        return self.completed - self.submitted


class QueuePair:
    """Bounded SQ + CQ with doorbell semantics (thread-safe)."""

    def __init__(self, sq_depth: int = 1024):
        self.sq_depth = sq_depth
        self._sq: collections.deque = collections.deque()
        self._cq: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._doorbell = threading.Condition(self._lock)   # SQ became nonempty
        self._not_full = threading.Condition(self._lock)   # SQ drained
        self._cq_ready = threading.Condition(self._lock)   # CQ grew

    def submit(self, req: SearchRequest, block: bool = False,
               timeout: Optional[float] = None) -> bool:
        """Append to the SQ and ring the doorbell.  Returns False when the
        queue is full (back-pressure) and ``block`` is False or timed out."""
        with self._lock:
            if len(self._sq) >= self.sq_depth:
                if not block:
                    return False
                ok = self._not_full.wait_for(
                    lambda: len(self._sq) < self.sq_depth, timeout)
                if not ok:
                    return False
            self._sq.append(req)
            self._doorbell.notify_all()
            return True

    def sq_len(self) -> int:
        with self._lock:
            return len(self._sq)

    def cq_len(self) -> int:
        with self._lock:
            return len(self._cq)

    def pop_submissions(self, max_n: int = 0) -> list[SearchRequest]:
        """Poller side: drain up to max_n (0 = all) submissions FIFO."""
        with self._lock:
            n = len(self._sq) if max_n <= 0 else min(max_n, len(self._sq))
            out = [self._sq.popleft() for _ in range(n)]
            if out:
                self._not_full.notify_all()
            return out

    def wait_submissions(self, timeout: Optional[float] = None) -> bool:
        """Poller side: sleep until the doorbell rings (or timeout)."""
        with self._lock:
            return self._doorbell.wait_for(lambda: len(self._sq) > 0, timeout)

    def complete(self, comps: list[Completion]) -> None:
        with self._lock:
            self._cq.extend(comps)
            if comps:
                self._cq_ready.notify_all()

    def poll(self, max_n: int = 0) -> list[Completion]:
        """Consumer side: drain up to max_n (0 = all) completions FIFO."""
        with self._lock:
            n = len(self._cq) if max_n <= 0 else min(max_n, len(self._cq))
            return [self._cq.popleft() for _ in range(n)]

    def wait_completions(self, n: int = 1,
                         timeout: Optional[float] = None) -> bool:
        with self._lock:
            return self._cq_ready.wait_for(lambda: len(self._cq) >= n, timeout)


def make_route_plan(cids_row: np.ndarray, nprobe: int, source) -> RoutePlan:
    """THE RoutePlan constructor — one definition of the probe signature
    (live cluster ids among the first ``nprobe`` routed), shared by the
    engine and by benches that pre-route a query pool, so the formation
    input measured offline is byte-for-byte what the engine feeds form."""
    n = int(nprobe)
    return RoutePlan(
        cids=cids_row, nprobe=n,
        probe_set=frozenset(int(c) for c in cids_row[:n] if c >= 0),
        source=source)


def route_requests(reqs: list, pipe, chunk: int = 0) -> None:
    """Tag each request with its RoutePlan from ``pipe`` in batched
    centroid+LLSP calls.  Requests already routed by this pipe are skipped
    (routing runs at most once per request per index version); a stale
    route from a swapped-out pipeline is recomputed against the live one.

    ``chunk`` (0 = everything at once) slices the call into warmed jit
    shapes: callers pass the batcher's max_batch so a deep pending pool
    never triggers a one-off compile of a pool-sized plan program mid-
    traffic — the cliff the pipeline warmup exists to prevent."""
    todo = [r for r in reqs
            if r.route is None or r.route.source is not pipe]
    if not todo:
        return
    step = len(todo) if chunk <= 0 else chunk
    for lo in range(0, len(todo), step):
        part = todo[lo:lo + step]
        qs = np.stack([r.query for r in part])
        tk = np.asarray([r.topk for r in part], np.int32)
        cids, nprobe = pipe.route(qs, tk)
        for i, r in enumerate(part):
            r.route = make_route_plan(cids[i], nprobe[i], pipe)


@dataclasses.dataclass
class EngineStats:
    submitted: int = 0
    rejected: int = 0               # SQ-full back-pressure
    completed: int = 0
    shed: int = 0
    degraded: int = 0
    partial: int = 0                # answered from an incomplete shard set
    failed: int = 0                 # serving-path error; completed w/o payload
    batches: int = 0
    service_s: float = 0.0          # summed batch service time


class ServeEngine:
    """SQ -> batcher -> prefetch pipeline -> CQ, with an N-deep window.

    ``pipelines`` maps index name -> PrefetchPipeline (the §4.2 multi-index
    node).  The engine itself is pipeline-agnostic: it only needs the
    ``plan / prefetch / dispatch / harvest`` stage protocol (and, optionally,
    ``route`` for admission-time locality tagging).

    ``depth`` is the in-flight window: how many dispatched-but-unharvested
    batches the poller keeps on the device stream before blocking on the
    oldest readback.  depth=1 is the plain double buffer (gather i+1 hides
    under scan i); deeper windows matter in the scan ≪ gather regime
    (streamed tiers: the scan is device-fast, the host gather is the long
    pole), where one
    in-flight scan finishes long before the next union is gathered and the
    device sits idle unless more batches are queued behind it.
    """

    def __init__(self, pipelines: dict, batcher, qp: Optional[QueuePair] = None,
                 clock=time.monotonic, update_lanes: Optional[dict] = None,
                 depth: int = 1, obs: Optional[Observability] = None,
                 quality=None):
        self.pipelines = dict(pipelines)
        self.batcher = batcher
        self.qp = qp or QueuePair()
        self.clock = clock
        self.depth = max(int(depth), 1)
        self.stats = EngineStats()
        self.obs = obs if obs is not None else Observability.off()
        m = self.obs.metrics
        self._m_comp = m.counter("engine.completions")    # labeled by status
        self._m_reason = m.counter("engine.not_ok")       # labeled by reason
        self._h_lat = m.histogram("engine.latency_s")
        self._h_service = m.histogram("engine.batch_service_s")
        self._g_pending = m.gauge("engine.pending")
        # flash-tier re-rank stage (quantized serving): round/candidate
        # distributions + the adaptive-stop hit counter, fed straight from
        # the pipeline's StageTimes stamps at harvest
        self._h_rr_rounds = m.histogram("engine.rerank_rounds")
        self._h_rr_cands = m.histogram("engine.rerank_cands")
        self._h_rr_io = m.histogram("engine.rerank_io_s")
        self._m_rr_stop = m.counter("engine.rerank_stop")  # labeled by kind
        self._h_rr_round_size = m.histogram("engine.rerank_round_size")
        # quality observability (repro_torch.obs.quality.QualityMonitor): fed one
        # call per harvested batch from the completion funnel — recall-proxy
        # streams, shadow audits, and the per-query telemetry harvest
        self.quality = quality
        self._req_ids = iter(range(1 << 62))
        self._swap_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._drain_on_stop = True
        # index lifecycle hooks (repro_torch.lifecycle): the update lane(s) the
        # poller pumps between search batches, and the version manager that
        # routes batches to epochs (set by VersionManager.bind)
        self.update_lanes: dict = dict(update_lanes or {})
        self.versions = None
        for name in self.pipelines:
            self._register_router(name)

    # -- client side -------------------------------------------------------
    def submit(self, query: np.ndarray, topk: int, index: Optional[str] = None,
               deadline_s: Optional[float] = None, block: bool = False) -> int:
        """Submit one query; returns req_id, or -1 on SQ back-pressure."""
        now = self.clock()
        if index is None:
            index = next(iter(self.pipelines))
        elif index not in self.pipelines:
            # fail on the CLIENT thread: an unknown index reaching the
            # poller would kill the serve loop for everyone
            raise KeyError(f"unknown index {index!r}")
        req = SearchRequest(
            req_id=next(self._req_ids), index=index,
            query=np.asarray(query, np.float32), topk=int(topk),
            deadline=None if deadline_s is None else now + deadline_s,
            arrival=now, trace_id=self.obs.mint(),
        )
        if not self.qp.submit(req, block=block):
            self.stats.rejected += 1
            self._m_comp.inc(1, "rejected")
            return -1
        self.stats.submitted += 1
        if req.trace_id:
            # async request-lifetime span: closed by the terminal event in
            # _complete (overlapping lifetimes, so "b"/"e" not "X")
            self.obs.trace.abegin(
                "request", f"req-{req.trace_id}", t=now,
                trace_id=req.trace_id, track="requests",
                args={"index": index, "req_id": req.req_id})
        return req.req_id

    # -- index lifecycle (rebuild/swap flow of launch/serve.py) ------------
    def swap_pipeline(self, name: str, pipeline) -> None:
        """Atomically swap in a freshly built index (daily-rebuild flow)."""
        with self._swap_lock:
            self.pipelines[name] = pipeline
            self.batcher.add_index(name)
        self._register_router(name)

    def add_update_lane(self, name: str, lane) -> None:
        """Attach an update lane (lifecycle/ingest.py) for ``name``: the
        poller drains it between search batches, update_quantum at a time."""
        self.update_lanes = {**self.update_lanes, name: lane}

    def _pipeline(self, name: str):
        with self._swap_lock:
            return self.pipelines[name]

    def _pump_updates(self, now: float, drain: bool = False) -> int:
        """Apply a bounded quantum of pending update ops per lane (the
        interleave point: called between search batches, never inside one).
        ``drain=True`` flushes everything (shutdown path)."""
        budget = 0 if drain else self.batcher.policy.update_quantum
        n = 0
        for lane in self.update_lanes.values():
            n += lane.pump(now, budget)
        return n

    # -- poller ------------------------------------------------------------
    def _routing_pipeline(self, name: str):
        """Pipeline whose centroids route admissions for ``name`` — the
        current epoch's when versions are bound (no in-flight ref taken:
        routing is advisory, the batch takes its epoch at formation)."""
        if self.versions is not None:
            try:
                return self.versions.current(name).pipeline
            except KeyError:
                pass
        return self._pipeline(name)

    def _register_router(self, name: str) -> None:
        """Expose the index's probe router to the batcher.  Routing runs at
        most once per request, but WHERE it runs is amortization-driven:
        a burst drained off the SQ is routed immediately (one batched
        centroid+LLSP call), while trickle arrivals are left for the
        batcher to route in one pooled call at formation time — per-query
        routing cost identical to the per-batch plan, never a
        per-arrival jit dispatch.

        ``route`` is optional in the stage protocol, so a swap to a
        route-less pipeline DEREGISTERS the router, and the closure
        re-checks the live pipeline every call — the poller must degrade
        to FIFO-style replanning, never crash, when an epoch swap changes
        the pipeline's capabilities mid-traffic."""
        routers = {**getattr(self.batcher, "routers", {})}
        pipe = self._routing_pipeline(name)
        if getattr(pipe, "route", None) is None:
            routers.pop(name, None)
            self.batcher.routers = routers
            return

        def router(reqs: list) -> None:
            live = self._routing_pipeline(name)
            if getattr(live, "route", None) is None:
                return
            route_requests(reqs, live, chunk=self.batcher.policy.max_batch)

        routers[name] = router
        self.batcher.routers = routers

    def _complete(self, comps: list) -> None:
        """THE completion funnel: every CQ push goes through here so the
        metrics (status/reason counters, latency histogram) and the trace's
        terminal events cannot drift from what clients observe."""
        if not comps:
            return
        tr = self.obs.trace
        for c in comps:
            self._m_comp.inc(1, c.status)
            if c.status != "ok":
                self._m_reason.inc(1, c.reason or c.status)
            if c.status != "shed":
                self._h_lat.observe(c.latency)
            if c.trace_id:
                # exactly ONE terminal instant per admitted trace — the
                # trace-integrity tests count these
                tr.instant(
                    f"done:{c.status}", t=c.completed, trace_id=c.trace_id,
                    track="requests",
                    args={"status": c.status, "reason": c.reason,
                          "latency_ms": round(c.latency * 1e3, 3)})
                tr.aend("request", f"req-{c.trace_id}", t=c.completed,
                        track="requests")
        self.qp.complete(comps)

    def _drain_sq(self, now: float) -> None:
        sheds, by_index = [], {}
        tracing = self.obs.tracing
        for req in self.qp.pop_submissions():
            c = self.batcher.add(req, now)
            if c is not None:
                sheds.append(c)
            else:
                if tracing and req.trace_id:
                    self.obs.trace.instant(
                        "admitted", t=now, trace_id=req.trace_id,
                        track="requests")
                by_index.setdefault(req.index, []).append(req)
        for name, group in by_index.items():
            # eager admission routing only when formation will use it AND
            # the drained group already amortizes the call (a burst);
            # trickles are routed in one pooled call at formation
            # (batcher.routers), fifo mode plans per batch as before
            if (self.batcher.policy.grouping == "locality"
                    and len(group) >= self.batcher.policy.pad):
                pipe = self._routing_pipeline(name)
                if getattr(pipe, "route", None) is not None:
                    route_requests(group, pipe,
                                   chunk=self.batcher.policy.max_batch)
        if sheds:
            self.stats.shed += len(sheds)
            self.stats.completed += len(sheds)
            self._complete(sheds)
        self._g_pending.set(self.batcher.pending())

    def _complete_batch(self, mb, result, done: float, epoch=None) -> None:
        comps = []
        partial = getattr(result, "partial", None)
        partial_reason = getattr(result, "partial_reason", "no_replica")
        quality = getattr(result, "quality", None)
        for i, req in enumerate(mb.requests):
            status, reason = ("degraded", "deadline") if mb.degraded[i] \
                else ("ok", "")
            if partial is not None and partial[i]:
                # fabric degraded mode outranks nprobe degradation: the
                # client must know the shard set was incomplete
                status, reason = "partial", partial_reason
                self.stats.partial += 1
            comps.append(Completion(
                req_id=req.req_id, index=req.index, status=status,
                ids=result.ids[i], dists=result.dists[i],
                nprobe=int(result.nprobe[i]),
                submitted=req.arrival, completed=done,
                reason=reason, trace_id=req.trace_id,
                quality=float(quality[i]) if quality is not None else -1.0,
            ))
        self.stats.degraded += int(mb.degraded.sum())
        self.stats.completed += len(comps)
        self.stats.batches += 1
        if epoch is not None:
            self.versions.harvested(epoch)
        if result.fresh_seq >= 0:
            lane = self.update_lanes.get(mb.index)
            if lane is not None:
                # visibility stamp: every update op covered by this batch's
                # snapshot now has a search response that could contain it
                lane.mark_visible(result.fresh_seq, done)
        # marginal batch cost = its own stage durations, NOT wall span from
        # plan_start (in the pipelined steady state that span also covers
        # the previous batch's in-flight scan and would inflate the EWMA
        # ~2x, making admission control shed meetable requests)
        t = result.times
        service = (t.plan_end - t.plan_start) + (t.scan_done - t.scan_dispatch)
        if t.rerank_end > t.rerank_start:
            service += t.rerank_end - t.rerank_start
            self._h_rr_rounds.observe(t.rerank_rounds)
            self._h_rr_cands.observe(t.rerank_cands)
            self._h_rr_io.observe(t.rerank_io_s)
            self._m_rr_stop.inc(
                1, "stable" if t.rerank_stable_stop else "exhausted")
            if t.rerank_round_size:
                self._h_rr_round_size.observe(t.rerank_round_size)
        self.stats.service_s += service
        self._h_service.observe(service)
        self.batcher.observe(len(mb.requests), service)
        if self.obs.tracing:
            self._emit_batch_spans(t, mb)
        if self.quality is not None:
            self.quality.observe_batch(
                mb.requests, comps,
                shards=getattr(result, "shards", None),
                rerank_rounds=t.rerank_rounds)
        self._complete(comps)

    def _emit_batch_spans(self, t, mb) -> None:
        """Stage spans for one served batch, from the StageTimes stamps the
        pipeline already took (zero extra clock reads).  Batches overlap in
        the depth>1 window, so each goes on a rotating ``batch-N`` lane —
        spans within one batch are sequential and nest under the parent."""
        tids = [r.trace_id for r in mb.requests if r.trace_id]
        if not tids:
            return
        spans = stage_spans(t)
        if not spans:
            return
        lane = f"batch-{self.stats.batches % 16}"
        tr = self.obs.trace
        tr.span("batch", min(a for _, a, _ in spans),
                max(b for _, _, b in spans), trace_id=tids[0], track=lane,
                args={"n": len(mb.requests), "index": mb.index,
                      "trace_ids": tids[:32]})
        for name, a, b in spans:
            tr.span(name, a, b, track=lane)

    def _form_and_plan(self, now: float, force: bool = False):
        """Form the next micro-batch and run its plan stage (device idle
        here by construction — before the current batch's scan dispatch).

        Epoch routing happens HERE: the batch takes an in-flight reference
        on the current epoch and carries it to harvest, so a concurrent
        swap cannot re-route (or early-retire) a batch mid-flight."""
        mb, sheds = self.batcher.form(now, force=force)
        if sheds:
            self.stats.shed += len(sheds)
            self.stats.completed += len(sheds)
            self._complete(sheds)
        if mb is None:
            return None
        epoch = None
        if self.versions is not None:
            epoch = self.versions.route(mb.index)
        pipe = epoch.pipeline if epoch is not None else self._pipeline(mb.index)
        queries = np.stack([r.query for r in mb.requests])
        topk = np.asarray([r.topk for r in mb.requests], np.int32)
        # reuse the admission-time routing when every request in the batch
        # was routed by THIS pipeline; a stale route (epoch swapped between
        # admission and formation) replans against the live centroids
        routed = None
        routes = [r.route for r in mb.requests]
        if all(rt is not None and rt.source is pipe for rt in routes):
            routed = (np.stack([rt.cids for rt in routes]),
                      np.asarray([rt.nprobe for rt in routes], np.int32))
        kwargs = {}
        if getattr(pipe, "accepts_deadline", False):
            # deadline-aware pipelines (the sharded fabric) hedge and give
            # up against the batch's tightest request deadline
            dls = [r.deadline for r in mb.requests if r.deadline is not None]
            kwargs["deadline"] = min(dls) if dls else None
        try:
            plan = pipe.plan(queries, topk, nprobe_cap=mb.nprobe_cap,
                             routed=routed, **kwargs)
        except Exception:
            # the batch is already formed — its requests MUST complete
            # (failed), never be abandoned with clients blocked on the CQ
            self._fail_batch(mb, now, epoch=epoch, reason="plan_error")
            return None
        if self.obs.tracing:
            # sampled request identities ride the plan into the fabric so
            # every shard task (incl. requeue/hedge) tags its queries
            plan.trace_ids = tuple(
                r.trace_id for r in mb.requests if r.trace_id)
        return mb, pipe, plan, epoch

    def step(self, now: Optional[float] = None, force: bool = True) -> int:
        """Synchronous single-batch step (tests / virtual clock): drain the
        SQ, form one micro-batch, serve it end-to-end.  Returns the number
        of completions produced."""
        now = self.clock() if now is None else now
        before = self.stats.completed
        self._drain_sq(now)
        self._pump_updates(now)
        planned = self._form_and_plan(now, force=force)
        if planned is not None:
            mb, pipe, plan, epoch = planned
            result = pipe.harvest(pipe.dispatch(pipe.prefetch(plan)))
            self._complete_batch(mb, result,
                                 self.clock() if now is None else now,
                                 epoch=epoch)
        return self.stats.completed - before

    def _fail_batch(self, mb, done: float, epoch=None,
                    reason: str = "serve_error") -> None:
        """Complete a formed batch as "failed" — the serving path errored,
        but every client gets a CQ entry (no abandoned requests, the
        shutdown/crash-drain invariant).  ``reason`` names the stage that
        errored ("plan_error", "prefetch_error", …)."""
        comps = [Completion(
            req_id=r.req_id, index=r.index, status="failed",
            ids=None, dists=None, nprobe=0,
            submitted=r.arrival, completed=done,
            reason=reason, trace_id=r.trace_id,
        ) for r in mb.requests]
        self.stats.failed += len(comps)
        self.stats.completed += len(comps)
        self.stats.batches += 1
        if epoch is not None:
            self.versions.harvested(epoch)
        self._complete(comps)

    def _flush_pending(self) -> None:
        """Shed everything admitted but not yet formed (batcher pools) plus
        SQ residents — the ``stop(drain=False)`` path used to abandon both,
        leaving blocked clients waiting on completions that never came."""
        now = self.clock()
        reqs = self.batcher.drain_pending() + self.qp.pop_submissions()
        if not reqs:
            return
        comps = [Completion(
            req_id=r.req_id, index=r.index, status="shed",
            ids=None, dists=None, nprobe=0,
            submitted=r.arrival, completed=now,
            reason="drain", trace_id=r.trace_id,
        ) for r in reqs]
        self.stats.shed += len(comps)
        self.stats.completed += len(comps)
        self._complete(comps)

    def _harvest_head(self, inflight) -> None:
        mb, pipe, infl, epoch = inflight.popleft()
        try:
            result = pipe.harvest(infl)
        except Exception:
            # a harvest error must not kill the poller with the window
            # still holding batches: this batch fails, the rest continue
            self._fail_batch(mb, self.clock(), epoch=epoch,
                             reason="harvest_error")
            return
        self._complete_batch(mb, result, self.clock(), epoch=epoch)

    def _prep_or_fail(self, planned):
        """Run the prefetch stage; on error the batch completes as failed
        instead of being dropped between stages."""
        mb, pipe, plan, epoch = planned
        try:
            return (mb, pipe, pipe.prefetch(plan), epoch)
        except Exception:
            self._fail_batch(mb, self.clock(), epoch=epoch,
                             reason="prefetch_error")
            return None

    def _dispatch_or_fail(self, prep, inflight) -> None:
        mb, pipe, h, epoch = prep
        try:
            inflight.append((mb, pipe, pipe.dispatch(h), epoch))
        except Exception:
            self._fail_batch(mb, self.clock(), epoch=epoch,
                             reason="dispatch_error")

    def _serve_loop(self) -> None:
        """Overlapped poller: while up to ``depth`` batches scan on device,
        the next batch is formed, planned, and its cluster union gathered /
        streamed on host.

        The plan stage of the next batch runs BEFORE the prepared batch's
        scan dispatch so its (small) device work is not queued behind the
        (large) scan on the backend's in-order execution stream — this
        ordering is what makes the host gather actually land inside the
        scan-in-flight window.  The in-flight deque holds dispatched,
        unharvested batches; the poller only blocks on the OLDEST readback,
        and only when the window is full or there is nothing left to prep —
        so with depth >= 2 a short scan finishing early never idles the
        device while the next gather is still on the host.
        """
        prep = None                    # (mb, pipe, prefetch-handle, epoch)
        inflight = collections.deque() # (mb, pipe, scan-handle, epoch)
        try:
            while not self._stop.is_set():
                now = self.clock()
                self._drain_sq(now)
                # update interleave point: BETWEEN batches, a bounded
                # quantum — an update storm back-pressures its own SQ,
                # search cadence holds
                self._pump_updates(now)
                if prep is None:
                    planned = self._form_and_plan(now)
                    if planned is not None:
                        prep = self._prep_or_fail(planned)
                        continue       # give the SQ one more drain pass
                    if inflight:
                        self._harvest_head(inflight)
                        continue
                    self.qp.wait_submissions(
                        timeout=self.batcher.policy.max_wait_s)
                    continue
                if len(inflight) >= self.depth:
                    self._harvest_head(inflight)
                    continue
                # commit the prepared batch: plan the NEXT batch first
                # (device idle for it), dispatch the scan into the in-flight
                # window, then gather the next batch under the window's
                # scans.
                nxt = self._form_and_plan(now)
                self._dispatch_or_fail(prep, inflight)
                prep = None
                if nxt is not None:
                    prep = self._prep_or_fail(nxt)
            # drain: finish anything still prepared or in flight
            if prep is not None:
                self._dispatch_or_fail(prep, inflight)
                prep = None
            while inflight:
                self._harvest_head(inflight)
            while self._drain_on_stop:
                now = self.clock()
                self._drain_sq(now)
                self._pump_updates(now, drain=True)
                planned = self._form_and_plan(now, force=True)
                if planned is None:
                    if self.batcher.pending() > 0:
                        continue      # a fully-shed batch is not "drained"
                    break
                mb, pipe, plan, epoch = planned
                try:
                    result = pipe.harvest(
                        pipe.dispatch(pipe.prefetch(plan)))
                except Exception:
                    self._fail_batch(mb, self.clock(), epoch=epoch,
                                     reason="harvest_error")
                    continue
                self._complete_batch(mb, result, self.clock(), epoch=epoch)
            if not self._drain_on_stop:
                self._flush_pending()
        except BaseException:
            # last-resort crash drain: whatever still holds requests when
            # the poller unwinds (targeted guards missed, or a bug in the
            # loop itself) completes as failed/shed rather than leaving
            # clients blocked on CQ entries that will never arrive
            if prep is not None:
                mb, _, _, epoch = prep
                self._fail_batch(mb, self.clock(), epoch=epoch,
                                 reason="crash_drain")
            while inflight:
                mb, _, _, epoch = inflight.popleft()
                self._fail_batch(mb, self.clock(), epoch=epoch,
                                 reason="crash_drain")
            self._flush_pending()
            raise

    def start(self) -> None:
        assert self._thread is None, "engine already started"
        self._stop.clear()
        self._drain_on_stop = True
        self._thread = threading.Thread(
            target=self._serve_loop, name="serve-poller", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the poller; by default finishes every admitted request."""
        if self._thread is None:
            return
        self._drain_on_stop = drain
        self._stop.set()
        self._thread.join()
        self._thread = None
