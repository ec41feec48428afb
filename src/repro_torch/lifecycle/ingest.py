"""Update lane (port of ``repro.lifecycle.ingest``): the ingest half of the
index lifecycle runtime (§6.2/§6.3).

The paper's deployment takes updates concurrently with search: recent
insertions land in an in-memory auxiliary buffer, deletions set tombstone
bits, and queries merge both against the main index.

* :class:`LiveFreshState` — the mutable serving-side freshness state: a
  host-authoritative delta buffer + tombstone bitmap over the global id
  space (ids are stable across rebuilds), published to the device as an
  immutable :class:`FreshSnapshot` that search batches capture at
  dispatch.  ``publish`` copies (``torch.tensor``): ``torch.from_numpy``
  would alias the host buffers on the CPU, and a later insert would change
  a snapshot that batches in flight still read.
* :class:`UpdateLane` — a second bounded SQ/CQ queue pair carrying
  insert/delete ops, drained by the engine's poller between search batches
  with a per-cycle budget (``BatchPolicy.update_quantum``), so an update
  storm back-pressures its own SQ instead of starving search.

Visibility is measured: every applied op records the publish sequence
number that first contains it; when a search batch whose captured snapshot
covers that sequence harvests, the op is stamped visible, so
``insert-to-visible`` is the client-observable interval.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import Observability
from repro_torch.runtime.engine import QueuePair


@dataclasses.dataclass(frozen=True)
class FreshSnapshot:
    """Immutable device view of the freshness state at one publish point."""
    seq: int
    fill: int
    delta_vecs: torch.Tensor       # (capacity, D) f32
    delta_ids: torch.Tensor        # (capacity,) int32, -1 = empty
    tombstone: torch.Tensor        # (id_capacity,) bool


class LiveFreshState:
    """Host-authoritative delta buffer + tombstones with device publishing.

    ``n_main`` is the number of ids already owned by the main index (the
    corpus rows at epoch start); inserts mint ids ``next_id, next_id+1, …``
    so the id space stays append-only and globally stable.  ``capacity``
    bounds the delta buffer — a full buffer rejects inserts, which is the
    rebuild-due signal (the paper's hourly/daily cadence trigger).

    Thread contract: mutators take ``lock``; ``snapshot()`` is a lock-free
    read of the last published immutable snapshot (atomic reference load).
    The rebuild scheduler takes ``lock`` to snapshot/carry state at swap.
    Snapshots live on ``device`` (the CUDA card by default).
    """

    def __init__(self, dim: int, capacity: int, n_main: int,
                 next_id: Optional[int] = None, seq0: int = 0, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.n_main = int(n_main)
        self.next_id = int(n_main if next_id is None else next_id)
        self.id_capacity = self.next_id + self.capacity
        self.lock = threading.RLock()
        self.fill = 0
        self.seq = int(seq0)               # global-monotonic across epochs
        self.n_tombstoned = 0
        self._delta_vecs = np.zeros((self.capacity, self.dim), np.float32)
        self._delta_ids = np.full((self.capacity,), -1, np.int32)
        self._tombstone = np.zeros((self.id_capacity,), bool)
        self._snapshot: Optional[FreshSnapshot] = None
        self.publish()

    # -- mutators (call under self.lock via UpdateLane / scheduler) --------
    def insert(self, vecs: np.ndarray) -> np.ndarray:
        """Append to the delta buffer; returns minted global ids.  Raises
        BufferError when full — the rebuild-due signal."""
        vecs = np.asarray(vecs, np.float32).reshape(-1, self.dim)
        n = vecs.shape[0]
        with self.lock:
            if self.fill + n > self.capacity:
                raise BufferError(
                    f"delta buffer full ({self.fill}+{n}>{self.capacity}): "
                    f"rebuild due")
            ids = np.arange(self.next_id, self.next_id + n, dtype=np.int32)
            self._delta_vecs[self.fill:self.fill + n] = vecs
            self._delta_ids[self.fill:self.fill + n] = ids
            self.fill += n
            self.next_id += n
            return ids

    def delete(self, ids: np.ndarray) -> int:
        """Tombstone ids; unminted ids are ignored.  Returns # newly dead."""
        ids = np.asarray(ids, np.int64).ravel()
        with self.lock:
            ids = ids[(ids >= 0) & (ids < self.next_id)]
            fresh_kills = int((~self._tombstone[ids]).sum())
            self._tombstone[ids] = True
            self.n_tombstoned += fresh_kills
            return fresh_kills

    def publish(self) -> int:
        """Copy the current host state to the device as a new immutable
        snapshot; returns its sequence number.  One copy per pump cycle,
        not per op: the batching is part of the measured insert-to-visible
        latency."""
        with self.lock:
            self.seq += 1
            # torch.tensor copies, on the CPU too; torch.from_numpy would
            # alias the host buffers, and an aliased "snapshot" would change
            # under in-flight batches on the next insert
            dev = self.device
            self._snapshot = FreshSnapshot(
                seq=self.seq, fill=self.fill,
                delta_vecs=torch.tensor(self._delta_vecs, device=dev),
                delta_ids=torch.tensor(self._delta_ids, device=dev),
                tombstone=torch.tensor(self._tombstone, device=dev),
            )
            return self.seq

    def already_covered(self, ids: np.ndarray) -> bool:
        """True when a delete of ``ids`` is fully covered by existing
        tombstones: it names at least one minted id and every minted id in
        it is already dead (a newer tombstone covers it — the update lane
        drops such deletes instead of re-applying them).  A delete naming
        no minted ids at all is NOT covered: it takes the normal apply
        path (a no-op there) so its completion stays "ok", as before."""
        ids = np.asarray(ids, np.int64).ravel()
        with self.lock:
            ids = ids[(ids >= 0) & (ids < self.next_id)]
            return ids.size > 0 and bool(self._tombstone[ids].all())

    # -- readers -----------------------------------------------------------
    def snapshot(self) -> FreshSnapshot:
        return self._snapshot

    @property
    def fill_frac(self) -> float:
        return self.fill / max(self.capacity, 1)

    @property
    def tombstone_frac(self) -> float:
        return self.n_tombstoned / max(self.next_id, 1)

    # -- swap-time accessors (scheduler holds self.lock) -------------------
    def delta_rows(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        return (self._delta_vecs[lo:hi].copy(), self._delta_ids[lo:hi].copy())

    def tombstone_bits(self) -> np.ndarray:
        return self._tombstone.copy()

    def adopt(self, vecs: np.ndarray, ids: np.ndarray,
              tombstone: np.ndarray) -> None:
        """Carry post-snapshot state into this (fresh) epoch state: the ops
        applied while the rebuild ran.  Called under both states' locks at
        swap time."""
        n = vecs.shape[0]
        if n > self.capacity:
            # recoverable: the scheduler retries, and the retry snapshots
            # the (larger) current fill into the fold, shrinking the carry
            raise RuntimeError(
                f"rebuild outran the new delta capacity ({n} carried ops "
                f"> {self.capacity}): retry folds them instead")
        with self.lock:
            self._delta_vecs[:n] = vecs
            self._delta_ids[:n] = ids
            self.fill = n
            m = min(tombstone.shape[0], self.id_capacity)
            self._tombstone[:m] = tombstone[:m]
            assert not tombstone[m:].any(), "tombstoned id beyond new epoch"
            self.n_tombstoned = int(self._tombstone.sum())


@dataclasses.dataclass
class UpdateRequest:
    """One update op submitted to the lane's SQ.  ``deadline`` (absolute
    clock time, None = best-effort) mirrors the search lane's admission
    control: an op the poller reaches past its deadline is shed, not
    applied late — freshness SLOs fail fast under storms instead of
    silently applying minutes-stale ops."""
    req_id: int
    op: str                            # "insert" | "delete"
    vecs: Optional[np.ndarray]         # (n, D) for insert
    ids: Optional[np.ndarray]          # (n,) for delete
    arrival: float = 0.0
    deadline: Optional[float] = None   # absolute; None = best-effort


@dataclasses.dataclass
class UpdateCompletion:
    """CQ entry.  status: "ok" | "rebuild_due" (insert rejected, buffer
    full — resubmit after the swap) | "shed" (deadline passed before the
    poller reached the op) | "covered" (delete dropped: every id was
    already tombstoned by a newer delete)."""
    req_id: int
    op: str
    status: str
    ids: Optional[np.ndarray]          # minted (insert) / affected (delete)
    seq: int                           # publish seq that first contains it
    submitted: float
    applied: float


@dataclasses.dataclass
class UpdateLaneStats:
    submitted: int = 0
    rejected: int = 0                  # SQ-full back-pressure
    applied_inserts: int = 0           # vectors, not requests
    applied_deletes: int = 0
    rejected_full: int = 0             # delta buffer full (rebuild due)
    shed_deadline: int = 0             # ops past deadline at pump time
    covered_deletes: int = 0           # deletes dropped (already tombstoned)
    pumps: int = 0
    publishes: int = 0
    visible: int = 0                   # ops stamped visible by a harvest
    visibility_dropped: int = 0        # pending stamps evicted (no search
                                       # traffic drained them)


class UpdateLane:
    """Bounded SQ/CQ pair for insert/delete ops, drained by the engine.

    ``pump`` applies up to ``budget`` ops against the CURRENT state (the
    lane retargets to the new epoch's state at swap), publishes once, and
    parks the applied ops until a search-batch harvest covers their publish
    seq — at which point ``mark_visible`` stamps the measured
    insert-to-visible interval into ``visible_log``.
    """

    def __init__(self, state: LiveFreshState, sq_depth: int = 4096,
                 clock=time.monotonic, obs: Optional[Observability] = None):
        self.state = state
        self.qp = QueuePair(sq_depth=sq_depth)
        self.clock = clock
        self.stats = UpdateLaneStats()
        self.obs = obs if obs is not None else Observability.off()
        # visibility intervals stream into bounded histograms (the daemon
        # runs for days); visible_log keeps only a RECENT raw window for
        # tests and spot checks — stats come from the histograms
        self._h_vis = {
            "insert": self.obs.metrics.histogram("ingest.insert_to_visible_s"),
            "delete": self.obs.metrics.histogram("ingest.delete_to_visible_s"),
        }
        self._req_ids = itertools.count(1)
        self._pending_vis: list = []           # applied, awaiting coverage
        self.visible_log: list = []            # (req_id, op, visible_s)
        self._vis_cap = 1 << 16                # pending-ledger bound
        self._raw_cap = 1024                   # recent raw visibility samples

    # -- client side -------------------------------------------------------
    def submit_insert(self, vecs: np.ndarray, block: bool = False,
                      deadline_s: Optional[float] = None) -> int:
        now = self.clock()
        req = UpdateRequest(req_id=next(self._req_ids), op="insert",
                            vecs=np.asarray(vecs, np.float32), ids=None,
                            arrival=now,
                            deadline=None if deadline_s is None
                            else now + deadline_s)
        return self._submit(req, block)

    def submit_delete(self, ids: np.ndarray, block: bool = False,
                      deadline_s: Optional[float] = None) -> int:
        now = self.clock()
        req = UpdateRequest(req_id=next(self._req_ids), op="delete",
                            vecs=None, ids=np.asarray(ids, np.int64),
                            arrival=now,
                            deadline=None if deadline_s is None
                            else now + deadline_s)
        return self._submit(req, block)

    def _submit(self, req: UpdateRequest, block: bool) -> int:
        if not self.qp.submit(req, block=block):
            self.stats.rejected += 1
            return -1
        self.stats.submitted += 1
        return req.req_id

    # -- poller side -------------------------------------------------------
    def pump(self, now: float, budget: int = 0) -> int:
        """Apply up to ``budget`` ops (0 = all pending) and publish once.
        Returns the number of ops applied.  Runs on the engine poller
        thread — one publish per pump keeps the device copy cost per cycle
        bounded no matter the storm size."""
        ops = self.qp.pop_submissions(budget)
        if not ops:
            return 0
        comps: list[UpdateCompletion] = []
        applied = []
        # lock-then-recheck: a concurrent epoch swap retargets the lane
        # UNDER the old state's lock, so acquiring a state's lock and then
        # finding it still current guarantees no swap lands mid-apply —
        # without the recheck, ops could be applied to a retired state
        # (lost inserts, duplicate global ids)
        while True:
            st = self.state
            st.lock.acquire()
            if st is self.state:
                break
            st.lock.release()
        try:
            seq_next = st.seq + 1              # the publish these ops join
            for req in ops:
                if req.deadline is not None and now > req.deadline:
                    # deadline admission, mirroring the search lane: an op
                    # the poller reached too late is failed fast — the
                    # client learns its freshness SLO broke instead of the
                    # op applying arbitrarily late
                    self.stats.shed_deadline += 1
                    comps.append(UpdateCompletion(
                        req_id=req.req_id, op=req.op, status="shed",
                        ids=None, seq=-1,
                        submitted=req.arrival, applied=now))
                    continue
                if req.op == "delete" and st.already_covered(req.ids):
                    # a newer tombstone already covers every id: dropping
                    # the delete is semantically free and saves a publish
                    self.stats.covered_deletes += 1
                    comps.append(UpdateCompletion(
                        req_id=req.req_id, op=req.op, status="covered",
                        ids=req.ids, seq=st.seq,
                        submitted=req.arrival, applied=now))
                    continue
                if req.op == "insert":
                    try:
                        ids = st.insert(req.vecs)
                    except BufferError:
                        self.stats.rejected_full += 1
                        comps.append(UpdateCompletion(
                            req_id=req.req_id, op=req.op,
                            status="rebuild_due", ids=None, seq=-1,
                            submitted=req.arrival, applied=now))
                        continue
                    self.stats.applied_inserts += len(ids)
                else:
                    st.delete(req.ids)
                    ids = req.ids
                    self.stats.applied_deletes += len(ids)
                c = UpdateCompletion(
                    req_id=req.req_id, op=req.op, status="ok", ids=ids,
                    seq=seq_next, submitted=req.arrival, applied=now)
                comps.append(c)
                applied.append(c)
            if applied:
                st.publish()
                self.stats.publishes += 1
        finally:
            st.lock.release()
        self.stats.pumps += 1
        self._pending_vis.extend(applied)
        if len(self._pending_vis) > self._vis_cap:
            # an ingest-only lane (no search traffic harvesting batches)
            # must not grow the visibility ledger without bound; dropped
            # entries are counted, not silently forgotten
            drop = len(self._pending_vis) - self._vis_cap
            self.stats.visibility_dropped += drop
            del self._pending_vis[:drop]
        self.qp.complete(comps)
        return len(applied)

    def mark_visible(self, covered_seq: int, at: float) -> int:
        """A search batch that captured snapshot ``covered_seq`` harvested
        at ``at``: every applied op with seq <= covered_seq is now
        client-visible.  Poller-thread only (same thread as pump)."""
        if not self._pending_vis:
            return 0
        still, done = [], 0
        for c in self._pending_vis:
            if c.seq <= covered_seq:
                dt = at - c.submitted
                self.visible_log.append((c.req_id, c.op, dt))
                self._h_vis[c.op].observe(dt)
                done += 1
            else:
                still.append(c)
        self._pending_vis = still
        self.stats.visible += done
        if len(self.visible_log) > self._raw_cap:
            del self.visible_log[: len(self.visible_log) - self._raw_cap // 2]
        return done

    def retarget(self, new_state: LiveFreshState) -> None:
        """Point the lane at the new epoch's state (swap time; the caller
        holds both states' locks via the scheduler)."""
        self.state = new_state

    def visibility_stats(self) -> dict:
        # percentiles come from the STREAMING histograms (full run, bounded
        # memory), not the truncated raw window — same keys as the old
        # latency_percentiles dict
        return {
            "insert_to_visible": self._h_vis["insert"].summary_ms(),
            "delete_to_visible": self._h_vis["delete"].summary_ms(),
            "n_visible": self.stats.visible,
            "n_pending": len(self._pending_vis),
        }
