"""Fault-tolerance runtime: heartbeats, straggler policy, serving failover.

At 1000+-node scale the failure model is: (a) a serving shard stops answering
(host/die failure), (b) a shard answers slowly (straggler), (c) a training
worker dies mid-step (handled by checkpoint/restart in launch/train.py).

* ``HeartbeatMonitor`` — logical-clock heartbeat table; a shard missing
  ``miss_threshold`` consecutive beats is marked failed, one marked slow for
  ``slow_factor``x median latency is a straggler.
* ``FailoverPlan`` — given failed shards and the ReplicaMap, compute the probe
  re-routing (clusters whose primary died scan a replica) and the irrecoverable
  set.  The sharded search engine consumes the resulting per-shard ownership
  mask; no resharding of the posting tensor is needed for R-1 failures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.storage.layout import ReplicaMap


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault against a serving fabric, relative to arm time.

    ``shard == -1`` defers the victim choice to fire time: a seeded draw
    among the shards still alive, so a schedule stays valid even if an
    earlier event already killed the shard a fixed id would have named."""
    at_s: float
    kind: str                  # "kill" | "stall" | "corrupt"
    shard: int = -1            # -1 = seeded choice among live shards at fire
    duration_s: float = 0.0    # stall/corrupt window length
    stall_s: float = 0.0       # per-task delay injected while stalled
    silent: bool = False       # kill only: no CQ flush — the shard just goes
                               # quiet, and detection must come from missed
                               # heartbeats instead of dead-letter replies
    fired: bool = False


class FaultInjector:
    """Seeded, replayable fault schedule for the sharded serving fabric.

    The injector is passive: the fabric's poller calls :meth:`poll` on its
    reply-pump path, and any event whose fire time has passed is applied to
    the fabric's shard node (kill / stall window / corrupt window).  All
    randomness (victim choice for ``shard=-1`` events) comes from one seeded
    generator, so a drill replays the identical fault sequence from
    (schedule, seed) — the property the kill-a-shard bench gates on.
    """

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 23]))
        # lint: bounded-by(drill schedule, fixed when the test configures it)
        self.events: list[FaultEvent] = []
        # lint: bounded-by(at most one entry per scheduled event)
        self.log: list[tuple[float, str, int]] = []   # (rel time, kind, shard)
        self._t0: Optional[float] = None

    # -- schedule ----------------------------------------------------------
    def kill(self, at_s: float, shard: int = -1,
             silent: bool = False) -> "FaultInjector":
        self.events.append(FaultEvent(at_s, "kill", shard, silent=silent))
        return self

    def stall(self, at_s: float, shard: int = -1, duration_s: float = 1.0,
              stall_s: float = 0.25) -> "FaultInjector":
        self.events.append(FaultEvent(at_s, "stall", shard,
                                      duration_s=duration_s, stall_s=stall_s))
        return self

    def corrupt(self, at_s: float, shard: int = -1,
                duration_s: float = 0.5) -> "FaultInjector":
        self.events.append(FaultEvent(at_s, "corrupt", shard,
                                      duration_s=duration_s))
        return self

    # -- runtime -----------------------------------------------------------
    def arm(self, t0: float) -> None:
        """Pin the schedule's zero time (defaults to the first poll)."""
        self._t0 = t0

    def pick_victim(self, alive: Sequence[int]) -> int:
        """Seeded victim draw for ``shard=-1`` events (exposed so tests can
        assert schedule determinism without a live fabric)."""
        alive = sorted(alive)
        if not alive:
            return -1
        return int(alive[int(self.rng.integers(0, len(alive)))])

    def poll(self, now: float, fabric) -> list[tuple[str, int]]:
        """Fire every due event against ``fabric`` (anything exposing
        ``alive_shards()`` and ``inject(event, shard)``).  Returns the
        (kind, shard) pairs fired this call."""
        if self._t0 is None:
            self._t0 = now
        el = now - self._t0
        fired = []
        for ev in sorted(self.events, key=lambda e: e.at_s):
            if ev.fired or el < ev.at_s:
                continue
            ev.fired = True
            shard = ev.shard if ev.shard >= 0 \
                else self.pick_victim(fabric.alive_shards())
            if shard < 0:
                continue
            fabric.inject(ev, shard)
            self.log.append((el, ev.kind, shard))
            fired.append((ev.kind, shard))
        return fired


@dataclasses.dataclass
class HeartbeatMonitor:
    n_nodes: int
    miss_threshold: int = 3
    slow_factor: float = 3.0

    def __post_init__(self):
        self.last_beat = np.zeros(self.n_nodes, dtype=np.int64)
        self.latency_ema = np.ones(self.n_nodes, dtype=np.float64)
        self.clock = 0

    def beat(self, node: int, latency: float = 1.0) -> None:
        self.last_beat[node] = self.clock
        self.latency_ema[node] = 0.8 * self.latency_ema[node] + 0.2 * latency

    def tick(self) -> None:
        self.clock += 1

    def failed(self) -> np.ndarray:
        return np.nonzero(self.clock - self.last_beat >= self.miss_threshold)[0]

    def stragglers(self) -> np.ndarray:
        alive = np.setdiff1d(np.arange(self.n_nodes), self.failed())
        if alive.size == 0:
            return alive
        med = np.median(self.latency_ema[alive])
        return alive[self.latency_ema[alive] > self.slow_factor * med]


@dataclasses.dataclass
class FailoverPlan:
    owner: np.ndarray          # (C,) serving shard per cluster after failover
    lost: np.ndarray           # clusters with no live replica
    moved: np.ndarray          # clusters whose owner changed

    @property
    def n_lost(self) -> int:
        return int(self.lost.size)


def plan_failover(
    replica_map: ReplicaMap, failed_shards: Sequence[int]
) -> FailoverPlan:
    primary = replica_map.replicas[:, 0].copy()
    fm = replica_map.failover(failed_shards)
    owner = fm.replicas[:, 0]
    lost = fm.lost_clusters()
    moved = np.nonzero((owner != primary) & (owner >= 0))[0]
    return FailoverPlan(owner=owner, lost=lost, moved=moved)


def ownership_mask(owner: np.ndarray, n_shards: int) -> np.ndarray:
    """(S, C) bool — shard s scans cluster c.  Consumed by the sharded search
    engine in place of the static striping when a failover plan is active."""
    mask = np.zeros((n_shards, owner.shape[0]), dtype=bool)
    valid = owner >= 0
    mask[owner[valid], np.nonzero(valid)[0]] = True
    return mask
