"""Dynamic micro-batching + deadline-aware admission control (§4.1/§4.2).

Device serving wants batches (one doorbell per batch, matrix-shaped work), but
traffic arrives one query at a time.  The batcher sits between the
submission queue and the scan pipeline and makes four decisions the paper's
runtime makes in its userspace stack:

* **coalescing** — accumulate single-query arrivals per index and release a
  micro-batch when it is full (``max_batch``) or its head-of-line request
  has waited ``max_wait_s`` (bounded batching delay);
* **locality grouping** — the packed scan distances every query in a batch
  against the batch's whole probed-cluster *union*, and the host tier
  gathers that union per batch; a batch of queries that probe the same
  clusters therefore costs a fraction of an arrival-order batch (the §4.1
  dependency-free batched-I/O economics, and FusionANNS's group-by-locality
  lesson).  When requests carry an admission-time :class:`RoutePlan`
  (cheap, pre-search features only — the §4.3 compatibility constraint),
  ``form`` packs greedily by probe-set overlap: every request older than
  ``max_wait_s`` is seeded FIFO (the aging guard — locality can reorder,
  never starve), then remaining slots go to the pending request whose probe
  set grows the running union least;
* **admission control / shedding** — a request whose deadline cannot be met
  even by the *fastest* path is completed immediately as ``shed`` (fail fast
  beats queueing doomed work — the paper's overload posture); a request that
  would miss its deadline at the routed LLSP level but could make it at a
  cheaper level is **degraded**: its nprobe is capped (``degrade_nprobe``),
  trading recall for latency instead of dropping the query.  Estimates are
  iterated to a fixed point on the *kept* set: shedding one doomed request
  shrinks the batch, and the survivors are re-judged against the batch that
  will actually run — never against peers that were themselves just shed;
* **fairness** — micro-batches are released round-robin across the node's
  co-resident indexes (§4.2 multi-index hosting), so a hot tenant cannot
  starve a cold one; within an index, FIFO order is preserved inside each
  released batch (selection can skip, the emitted request order cannot
  reorder).

All decisions are functions of (policy, observed-EWMA service rate, ``now``,
admission-time routes) only — replaying a seeded arrival trace against a
virtual clock reproduces the exact shed/degrade/batch sequence, which is
what the determinism tests assert.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np

from .engine import Completion, SearchRequest

_EMPTY_PROBES: frozenset = frozenset()


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    max_batch: int = 64            # release when this many are pending
    max_wait_s: float = 0.005      # ... or when head-of-line waited this long
    pad: int = 16                  # micro-batch quantum; keep equal to the
                                   # pipeline's pad_batch (the actual jit
                                   # padding knob) so warmups cover the
                                   # shapes the pipeline really compiles
    shed: str = "degrade"          # "none" | "shed" | "degrade"
    degrade_nprobe: int = 8        # nprobe cap for degraded requests
                                   # (lowest LLSP level bound)
    degrade_speedup: float = 2.0   # assumed service speedup of a degraded req
    overhead_s: float = 1e-3       # fixed per-batch cost (dispatch + merge)
    init_query_s: float = 1e-4     # prior per-query service estimate
    ewma: float = 0.3              # service-estimate smoothing
    update_quantum: int = 64       # max update-lane ops the poller applies
                                   # between search batches — bounds how much
                                   # an update storm can delay the next
                                   # micro-batch (storms back-pressure their
                                   # own SQ instead of starving search)
    grouping: str = "locality"     # "locality" | "fifo" micro-batch formation
                                   # (fifo = plain arrival order; requests
                                   # without a RoutePlan degrade to fifo
                                   # order under "locality" too)
    union_growth_cap: int = 0      # locality mode: stop filling a batch when
                                   # the best remaining candidate would add
                                   # more than this many new clusters to the
                                   # union (0 = always fill to max_batch);
                                   # skipped requests age into the next
                                   # batch's FIFO seed, so the cap trades
                                   # batch size for union tightness without
                                   # starving anyone


@dataclasses.dataclass
class MicroBatch:
    index: str
    requests: list                 # list[SearchRequest], FIFO
    nprobe_cap: np.ndarray         # (b,) int32, 0 = uncapped
    degraded: np.ndarray           # (b,) bool
    formed_at: float
    waits: Optional[np.ndarray] = None   # (b,) seconds in queue at formation
    probe_union: Optional[frozenset] = None  # union of admission-time probe
                                             # sets (None: no routed request)


@dataclasses.dataclass
class BatcherStats:
    admitted: int = 0
    shed_admission: int = 0        # dead on arrival (deadline unmeetable)
    shed_deadline: int = 0         # dropped at batch formation
    degraded: int = 0
    batches: int = 0
    locality_batches: int = 0      # batches formed by probe-overlap packing
    aged_seeds: int = 0            # requests force-seeded by the aging guard
    max_queue_wait_s: float = 0.0  # worst formation wait seen (aging bound
                                   # evidence: compare against max_wait_s)


def _probe_set(req: SearchRequest) -> frozenset:
    route = getattr(req, "route", None)
    return _EMPTY_PROBES if route is None else route.probe_set


class DynamicBatcher:
    """Per-index pending queues + round-robin micro-batch formation."""

    def __init__(self, policy: BatchPolicy, indexes: list[str]):
        self.policy = policy
        self._pending: dict[str, collections.deque] = {
            name: collections.deque() for name in indexes
        }
        self._rr = 0                       # round-robin cursor over indexes
        self.est_query_s = policy.init_query_s
        self.stats = BatcherStats()
        # per-index probe routers (set by the engine): called with the list
        # of still-unrouted pending requests ONCE per formation, so trickle
        # arrivals amortize the centroid+LLSP call over the whole pool
        # instead of paying a per-arrival jit dispatch
        self.routers: dict = {}

    @property
    def indexes(self) -> list[str]:
        return list(self._pending)

    def add_index(self, name: str) -> None:
        if name in self._pending:
            return
        # copy-on-write: the poller thread iterates self._pending without a
        # lock, so mutate by swapping in a new dict (atomic attribute store)
        # rather than inserting into the one being iterated
        self._pending = {**self._pending, name: collections.deque()}

    def pending(self, index: Optional[str] = None) -> int:
        if index is not None:
            return len(self._pending[index])
        return sum(len(q) for q in self._pending.values())

    def drain_pending(self) -> list:
        """Pull EVERY pending request out, FIFO within each index, indexes
        in registration order — the engine's no-drain shutdown path
        completes these as shed instead of abandoning them."""
        out: list = []
        for q in self._pending.values():
            while q:
                out.append(q.popleft())
        return out

    def observe(self, batch_size: int, service_s: float) -> None:
        """Fold a measured batch service time into the per-query EWMA."""
        if batch_size <= 0:
            return
        per_q = max(service_s - self.policy.overhead_s, 0.0) / batch_size
        a = self.policy.ewma
        self.est_query_s = (1 - a) * self.est_query_s + a * per_q

    # -- admission ---------------------------------------------------------
    def _min_latency(self, degraded: bool = False) -> float:
        est = self.policy.overhead_s + self.est_query_s
        return est / self.policy.degrade_speedup if degraded else est

    def add(self, req: SearchRequest, now: float) -> Optional[Completion]:
        """Admit a request; returns a shed Completion if it is dead on
        arrival (deadline unmeetable even solo + degraded), else None."""
        if req.index not in self._pending:
            raise KeyError(f"unknown index {req.index!r}")
        if req.deadline is not None and (
            now + self._min_latency(degraded=True) > req.deadline
        ):
            self.stats.shed_admission += 1
            return Completion(
                req_id=req.req_id, index=req.index, status="shed",
                ids=None, dists=None, nprobe=0,
                submitted=req.arrival, completed=now,
                reason="deadline", trace_id=req.trace_id,
            )
        self.stats.admitted += 1
        self._pending[req.index].append(req)
        return None

    # -- batch formation ---------------------------------------------------
    def _due(self, q: collections.deque, now: float) -> bool:
        """THE release predicate (shared by ready() and form(), so the two
        cannot drift): a queue is due when it can fill a batch or its
        head-of-line request has aged past the batching-delay bound."""
        if len(q) >= self.policy.max_batch:
            return True
        return bool(q) and now - q[0].arrival >= self.policy.max_wait_s

    def ready(self, now: float) -> bool:
        """Is some index due for release (full batch or head-of-line aged)?"""
        return any(self._due(q, now) for q in self._pending.values())

    def _pick_index(self, now: float, force: bool) -> Optional[str]:
        """Round-robin scan from the cursor; ``force`` takes any non-empty
        queue (drain path).  Advancing the cursor by scan offset — never by
        name lookup — keeps the drain order a deterministic function of
        (queue state, cursor), independent of how indexes were added."""
        names = list(self._pending)
        for off in range(len(names)):
            name = names[(self._rr + off) % len(names)]
            q = self._pending[name]
            if not q:
                continue
            if force or self._due(q, now):
                self._rr = (self._rr + off + 1) % len(names)
                return name
        return None

    def _select(self, name: str, q: collections.deque, now: float,
                force: bool) -> list[SearchRequest]:
        """Pull the next batch's requests out of ``q``.

        FIFO mode (or force-drain, or no routed request pending): the oldest
        ``max_batch`` requests, arrival order — exactly the pre-locality
        behavior, and the A/B baseline.

        Locality mode: every request older than ``max_wait_s`` is seeded
        first in FIFO order (aging guard — grouping may skip a request for
        at most one release cycle before it becomes a mandatory seed), then
        remaining slots are filled greedily with the request whose
        admission-time probe set adds the fewest new clusters to the running
        union (ties broken by arrival order, so unrouted requests — growth 0
        — degrade to FIFO).  The emitted list is re-sorted to arrival order:
        selection chooses *membership*, never response order.
        """
        limit = self.policy.max_batch
        snap = list(q)
        if self.policy.grouping == "locality" and not force:
            router = self.routers.get(name)
            if router is not None and snap:
                # one pooled centroid+LLSP call; the router itself skips
                # requests already routed by the LIVE pipeline, so this is
                # a no-op pass when everything is fresh but re-routes a
                # pool whose routes went stale across an epoch swap
                router(snap)
        locality = (self.policy.grouping == "locality" and not force
                    and any(_probe_set(r) for r in snap))
        if not locality:
            take = snap[:limit]
            for _ in take:
                q.popleft()
            return take
        aged = [i for i, r in enumerate(snap)
                if now - r.arrival >= self.policy.max_wait_s]
        sel = aged[:limit]
        self.stats.aged_seeds += len(sel)
        if not sel:
            sel = [0]                      # anchor on head-of-line
        chosen = set(sel)
        # vectorized greedy over cluster bitsets: the selection runs on the
        # poller's critical path, so the inner argmin is ONE numpy op over
        # (pool, C) bools per added request, not a python set loop — a
        # multi-hundred-request backlog must not stall batch release
        probes = [_probe_set(r) for r in snap]
        n_bits = 1 + max((max(p) for p in probes if p), default=0)
        bits = np.zeros((len(snap), n_bits), bool)
        for i, (r, p) in enumerate(zip(snap, probes)):
            if not p:
                continue
            rb = r.route
            if rb is not None:
                # cache the request's bit row on its RoutePlan: a pool
                # persists across formations, so the set -> bitset
                # conversion happens once per request, not once per batch
                if rb.bits is None:
                    rb.bits = np.zeros(max(p) + 1, bool)
                    rb.bits[list(p)] = True
                bits[i, : rb.bits.size] = rb.bits
            else:
                bits[i, list(p)] = True
        union = np.zeros(n_bits, bool)
        for i in sel:
            union |= bits[i]
        remaining = np.asarray(
            [i for i in range(len(snap)) if i not in chosen], np.int64)
        cap = self.policy.union_growth_cap
        while len(sel) < limit and remaining.size:
            growth = (bits[remaining] & ~union).sum(axis=1)
            pos = int(np.argmin(growth))   # first min = oldest (FIFO ties)
            if cap and int(growth[pos]) > cap:
                break                      # bounded union growth: leave the
                                           # outlier to age into the next
                                           # batch's mandatory seed
            best = int(remaining[pos])
            sel.append(best)
            chosen.add(best)
            union |= bits[best]
            remaining = np.delete(remaining, pos)
        take = [snap[i] for i in sorted(sel)]
        q.clear()
        q.extend(snap[i] for i in range(len(snap)) if i not in chosen)
        self.stats.locality_batches += 1
        return take

    def _admit(self, reqs: list[SearchRequest], now: float
               ) -> tuple[list[SearchRequest], np.ndarray, np.ndarray,
                          list[SearchRequest]]:
        """Deadline admission on a formed batch, iterated to a fixed point.

        The service estimate is a function of the batch size that actually
        runs, so shedding is iterative: drop the single most-doomed request
        (earliest deadline among those missing even the relaxed bound),
        re-estimate on the smaller batch, repeat.  A survivor is therefore
        never shed — or degraded — because of peers that were themselves
        just shed (judging everyone against the pre-shed batch size would
        over-shed exactly at the deadline boundary)."""
        pol = self.policy
        keep = list(reqs)
        sheds: list[SearchRequest] = []
        if pol.shed != "none":
            while keep:
                b = len(keep)
                est_relaxed = pol.overhead_s + self.est_query_s * b
                if pol.shed == "degrade":
                    est_relaxed = pol.overhead_s + (
                        self.est_query_s * b / pol.degrade_speedup)
                doomed = [r for r in keep if r.deadline is not None
                          and now + est_relaxed > r.deadline]
                if not doomed:
                    break
                victim = min(doomed, key=lambda r: r.deadline)
                keep.remove(victim)
                sheds.append(victim)
        b = len(keep)
        est_full = pol.overhead_s + self.est_query_s * b
        cap = np.zeros((b,), np.int32)
        deg = np.zeros((b,), bool)
        if pol.shed == "degrade":
            for i, r in enumerate(keep):
                if r.deadline is not None and now + est_full > r.deadline:
                    # fits the degraded bound by construction (fixed point)
                    deg[i] = True
                    cap[i] = pol.degrade_nprobe
                    self.stats.degraded += 1
        return keep, cap, deg, sheds

    def form(
        self, now: float, force: bool = False
    ) -> tuple[Optional[MicroBatch], list[Completion]]:
        """Release the next micro-batch (round-robin across indexes).

        Returns (batch-or-None, sheds) — ``sheds`` are requests dropped at
        formation time because even the degraded path would miss their
        deadline.  ``force`` releases a partial batch regardless of age, in
        strict FIFO order (drain/shutdown path — deterministic regardless of
        grouping mode).
        """
        pick = self._pick_index(now, force)
        if pick is None:
            return None, []
        reqs = self._select(pick, self._pending[pick], now, force)
        keep, cap, deg, shed_reqs = self._admit(reqs, now)
        sheds = []
        for r in shed_reqs:
            self.stats.shed_deadline += 1
            sheds.append(Completion(
                req_id=r.req_id, index=r.index, status="shed",
                ids=None, dists=None, nprobe=0,
                submitted=r.arrival, completed=now,
                reason="deadline", trace_id=r.trace_id,
            ))
        if not keep:
            return None, sheds
        waits = np.asarray([now - r.arrival for r in keep], np.float64)
        self.stats.max_queue_wait_s = max(self.stats.max_queue_wait_s,
                                          float(waits.max()))
        union: Optional[frozenset] = None
        if any(_probe_set(r) for r in keep):
            union = frozenset().union(*[_probe_set(r) for r in keep])
        self.stats.batches += 1
        return MicroBatch(
            index=pick, requests=keep,
            nprobe_cap=cap, degraded=deg, formed_at=now,
            waits=waits, probe_union=union,
        ), sheds
