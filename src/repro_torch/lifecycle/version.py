"""Epoch-tagged index versions + the atomic swap protocol (§6.2/§6.3).

A serving index that rebuilds under live traffic needs version management
(the distributed-storage ANNS line in PAPERS.md): queries must never observe
a half-swapped index, and the old version's resources must not be freed
while a batch still scans it.  The protocol here:

* every deployed index version is an :class:`Epoch` with a monotonically
  increasing id and its own pipeline + freshness state;
* the engine *routes* each micro-batch to the current epoch at batch
  formation, taking an in-flight reference — the batch carries its epoch to
  harvest, so a swap mid-flight cannot re-route it;
* ``swap`` publishes the new epoch atomically (under the engine's swap
  lock): new batches route to the new epoch, in-flight batches finish on
  the old one;
* the old epoch **retires** when its last in-flight batch harvests — only
  then is its host posting tier released (storage/host_tier.py ``release``)
  — so "zero dropped batches across a swap" is structural, and the epoch
  record counts every batch to prove it.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Optional


@dataclasses.dataclass
class EpochRecord:
    """Audit row kept in VersionManager.history for every epoch."""
    name: str
    eid: int
    created_at: float
    activated_at: float = 0.0
    retired_at: float = 0.0            # swap called: no new batches route here
    finalized_at: float = 0.0          # last in-flight batch harvested
    batches: int = 0                   # micro-batches served by this epoch


class Epoch:
    """One deployed index version: pipeline + freshness state + refcount."""

    def __init__(self, name: str, eid: int, pipeline, fresh=None,
                 clock=time.monotonic):
        self.name = name
        self.eid = eid
        self.pipeline = pipeline
        self.fresh = fresh             # LiveFreshState (None = static index)
        self.clock = clock
        self.record = EpochRecord(name=name, eid=eid, created_at=clock())
        self.retired = False
        self.finalized = threading.Event()
        self._inflight = 0
        self._lock = threading.Lock()
        if fresh is not None and getattr(pipeline, "fresh_source", None) is None:
            # bind the pipeline's per-batch snapshot capture to THIS epoch's
            # state: in-flight batches on a retired epoch keep reading the
            # frozen old state, never the new epoch's (swap semantics)
            pipeline.fresh_source = fresh.snapshot

    def acquire(self) -> "Epoch":
        with self._lock:
            self._inflight += 1
        return self

    def release(self) -> None:
        with self._lock:
            self._inflight -= 1
            self.record.batches += 1
            done = self.retired and self._inflight == 0
        if done:
            self._finalize()

    def retire(self) -> None:
        with self._lock:
            self.retired = True
            self.record.retired_at = self.clock()
            done = self._inflight == 0
        if done:
            self._finalize()

    def _finalize(self) -> None:
        if self.finalized.is_set():
            return
        self.record.finalized_at = self.clock()
        tier = getattr(self.pipeline, "tier", None)
        if tier is not None and hasattr(tier, "release"):
            tier.release()
        self.finalized.set()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight


class VersionManager:
    """Named epochs + atomic swap, bound to a ServeEngine.

    The engine consults ``route`` at micro-batch formation (taking the
    in-flight reference) and calls ``harvested`` at completion; everything
    else — deploy, swap, retirement — happens here.
    """

    # retained epoch records: a serving daemon swaps epochs for as long
    # as it lives, so the history is a recent window, not the full run
    # (the epoch_swap trace instants are the durable record)
    MAX_HISTORY = 256

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._epochs: dict[str, Epoch] = {}
        self._lock = threading.Lock()
        self._eids = itertools.count(1)
        self.history: list[EpochRecord] = []
        self.engine = None

    def _remember(self, record: EpochRecord) -> None:
        # call with self._lock held
        self.history.append(record)
        del self.history[: -self.MAX_HISTORY]

    def bind(self, engine) -> "VersionManager":
        """Attach to a ServeEngine: its poller routes through this manager
        for every deployed name."""
        self.engine = engine
        engine.versions = self
        return self

    def names(self) -> list[str]:
        with self._lock:
            return list(self._epochs)

    def current(self, name: str) -> Epoch:
        with self._lock:
            return self._epochs[name]

    def deploy(self, name: str, pipeline, fresh=None) -> Epoch:
        """Install the first epoch of ``name`` (no predecessor to retire)."""
        ep = Epoch(name, next(self._eids), pipeline, fresh, clock=self.clock)
        ep.record.activated_at = self.clock()
        with self._lock:
            assert name not in self._epochs, f"{name!r} already deployed"
            self._epochs[name] = ep
            self._remember(ep.record)
        if self.engine is not None:
            self.engine.swap_pipeline(name, pipeline)
        return ep

    def route(self, name: str) -> Optional[Epoch]:
        """Engine side: current epoch with an in-flight ref taken, or None
        for names this manager does not own."""
        with self._lock:
            ep = self._epochs.get(name)
            return None if ep is None else ep.acquire()

    def harvested(self, epoch: Epoch) -> None:
        epoch.release()

    def swap(self, name: str, pipeline, fresh=None) -> tuple[Epoch, Epoch]:
        """Atomic swap: publish the new epoch, retire the old.

        Returns (old, new).  In-flight batches hold their epoch reference,
        so the old epoch finalizes (tier released, record stamped) only
        after its last batch harvests — callers that must block on that use
        ``old.finalized.wait()``."""
        new = Epoch(name, next(self._eids), pipeline, fresh, clock=self.clock)
        with self._lock:
            old = self._epochs[name]
            self._epochs[name] = new
            new.record.activated_at = self.clock()
            self._remember(new.record)
        if self.engine is not None:
            self.engine.swap_pipeline(name, pipeline)
        old.retire()
        return old, new
