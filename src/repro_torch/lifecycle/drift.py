"""Centroid-drift monitor — the quality half of the rebuild trigger (a
copy of ``repro.lifecycle.drift``: numpy only, no device).

The fill/tombstone thresholds in :class:`~repro_torch.lifecycle.rebuild.
RebuildPolicy` are CAPACITY triggers: they fire when the delta buffer is
mechanically full, regardless of whether the partition still fits the
data.  But a drifting insert stream degrades recall long before the
buffer fills — new vectors land in clusters whose centroid no longer
describes them, the closure assignment spreads them across more replicas,
and nprobe has to grow to hold recall.  This module watches for exactly
that: per-cluster **mean-residual shift** of the delta inserts against
the owning centroid, normalized by the cluster's observed residual scale.

For each insert batch the monitor accumulates, per owning cluster,
``sum(x - c)``, ``sum(||x - c||)`` and a count; a cluster's *shift* is
``||mean residual|| / mean residual norm`` — 0 when inserts scatter
isotropically around the centroid (the stationary case), → 1 when they
pile up on one side (the centroid is no longer where its data is).  When
enough clusters drift past the threshold, :meth:`advisory` returns a
reason string that :meth:`RebuildScheduler.due` treats as a rebuild
trigger, and the transition lands as a ``rebuild_advisory`` instant on
the ``lifecycle`` trace track (hysteresis: one instant per excursion,
not one per poll).

Gauges (bounded label sets): ``drift.max_shift``,
``drift.clusters_drifted``, ``drift.observed``, plus the live freshness
ratios ``lifecycle.fill_frac`` / ``lifecycle.tombstone_frac`` when
:meth:`observe_state` is fed the lane state.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class DriftMonitor:
    """Streaming per-cluster insert-drift detector (see module doc).

    ``centroids`` is the (C, D) array the CURRENT epoch was built
    against; :meth:`reset` re-arms the accumulators after a rebuild
    (same centroids, fresh delta).  ``observe`` takes the insert batch
    plus optional owning cluster ids — when omitted, vectors are
    assigned to their nearest centroid here (exact argmin; insert
    batches are small and off the search path).
    """

    def __init__(self, centroids: np.ndarray, *, metrics=None, trace=None,
                 shift_threshold: float = 0.6, min_inserts: int = 32,
                 max_drifted: int = 1):
        self.centroids = np.ascontiguousarray(centroids, np.float32)
        self.metrics = metrics
        self.trace = trace
        self.shift_threshold = float(shift_threshold)
        self.min_inserts = int(min_inserts)
        self.max_drifted = int(max_drifted)
        c = self.centroids.shape[0]
        self._lock = threading.Lock()
        self._resid_sum = np.zeros_like(self.centroids)       # (C, D)
        self._resid_norm = np.zeros(c, np.float64)            # sum ||x-c||
        self._count = np.zeros(c, np.int64)
        self._advisory_live = False       # hysteresis latch for the instant
        self.advisories = 0

    # -- ingestion ---------------------------------------------------------
    def observe(self, vecs: np.ndarray,
                cids: Optional[np.ndarray] = None) -> None:
        """Fold one insert batch into the per-cluster residual stats."""
        x = np.asarray(vecs, np.float32).reshape(-1, self.centroids.shape[1])
        if x.shape[0] == 0:
            return
        if cids is None:
            d = (np.einsum("bd,bd->b", x, x)[:, None]
                 - 2.0 * (x @ self.centroids.T)
                 + np.einsum("cd,cd->c", self.centroids, self.centroids))
            cids = np.argmin(d, axis=1)
        cids = np.asarray(cids, np.int64).ravel()
        resid = x - self.centroids[cids]
        norms = np.linalg.norm(resid, axis=1)
        with self._lock:
            np.add.at(self._resid_sum, cids, resid)
            np.add.at(self._resid_norm, cids, norms)
            np.add.at(self._count, cids, 1)

    def observe_state(self, state) -> None:
        """Mirror the lane's capacity ratios into gauges (the operator's
        'how close is the NEXT capacity-triggered rebuild?' view)."""
        if self.metrics is None:
            return
        self.metrics.gauge("lifecycle.fill_frac").set(state.fill_frac)
        self.metrics.gauge("lifecycle.tombstone_frac").set(
            state.tombstone_frac)

    # -- readout -----------------------------------------------------------
    def shifts(self) -> np.ndarray:
        """(C,) per-cluster shift in [0, 1]; 0 for clusters with fewer
        than ``min_inserts`` observations (no evidence, no signal)."""
        with self._lock:
            cnt = self._count.copy()
            rs = self._resid_sum.copy()
            rn = self._resid_norm.copy()
        out = np.zeros(cnt.shape[0], np.float64)
        live = cnt >= self.min_inserts
        if live.any():
            mean_norm = np.linalg.norm(
                rs[live] / cnt[live, None], axis=1)
            scale = rn[live] / cnt[live]
            out[live] = mean_norm / np.maximum(scale, 1e-12)
        return out

    def severity(self) -> np.ndarray:
        """(C,) rebuild-priority score: assign-mass x shift.

        Shift alone mis-ranks: a 0.9 shift on a cluster absorbing 2%
        of the insert stream matters less than a 0.7 shift on one
        absorbing half of it.  Weighting by the cluster's share of
        observed inserts makes the ranking reflect how much of the
        delta a rebuild would actually re-home — and makes the order
        deterministic for equal shifts (mass breaks the tie; cluster
        id breaks exact severity ties, see :meth:`_rank`)."""
        s = self.shifts()
        with self._lock:
            cnt = self._count.copy()
        total = max(int(cnt.sum()), 1)
        return s * (cnt.astype(np.float64) / total)

    @staticmethod
    def _rank(sev: np.ndarray, top: int = 8) -> np.ndarray:
        """Descending severity; ascending cluster id on exact ties —
        the same inputs always rank the same way (np.argsort alone is
        not stable across tied float scores)."""
        order = np.lexsort((np.arange(sev.shape[0]), -sev))
        return order[:top]

    def advisory(self) -> Optional[str]:
        """Rebuild-advisory reason when drifted clusters exceed the
        policy, else None.  Emits one ``rebuild_advisory`` trace instant
        per excursion (latched until the signal clears or :meth:`reset`
        re-arms it)."""
        s = self.shifts()
        drifted = int((s >= self.shift_threshold).sum())
        mx = float(s.max()) if s.size else 0.0
        if self.metrics is not None:
            self.metrics.gauge("drift.max_shift").set(mx)
            self.metrics.gauge("drift.clusters_drifted").set(drifted)
            self.metrics.gauge("drift.observed").set(int(self._count.sum()))
        if drifted >= self.max_drifted:
            if not self._advisory_live:
                self._advisory_live = True
                self.advisories += 1
                if self.trace is not None:
                    sev = self.severity()
                    top = int(self._rank(sev, top=1)[0])
                    self.trace.instant(
                        "rebuild_advisory", track="lifecycle",
                        args={"clusters_drifted": drifted,
                              "max_shift": round(mx, 4),
                              "top_cluster": top,
                              "top_severity": round(float(sev[top]), 4)})
            return f"drift:{drifted}"
        self._advisory_live = False
        return None

    def summary(self) -> dict:
        """JSON-able rollup for health snapshots; ``top`` is ranked by
        severity (assign-mass x shift), deterministically."""
        s = self.shifts()
        sev = self.severity()
        order = self._rank(sev, top=8)
        with self._lock:
            total = int(self._count.sum())
        return {
            "observed": total,
            "max_shift": float(s.max()) if s.size else 0.0,
            "clusters_drifted":
                int((s >= self.shift_threshold).sum()),
            "threshold": self.shift_threshold,
            "advisories": self.advisories,
            "top": [{"cluster": int(c), "shift": float(s[c]),
                     "severity": float(sev[c]),
                     "inserts": int(self._count[c])}
                    for c in order if s[c] > 0.0],
        }

    def reset(self, centroids: Optional[np.ndarray] = None) -> None:
        """Re-arm after a rebuild folded the observed delta (optionally
        against the new epoch's centroids)."""
        with self._lock:
            if centroids is not None:
                self.centroids = np.ascontiguousarray(centroids,
                                                      np.float32)
                self._resid_sum = np.zeros_like(self.centroids)
                self._resid_norm = np.zeros(self.centroids.shape[0],
                                            np.float64)
                self._count = np.zeros(self.centroids.shape[0], np.int64)
            else:
                self._resid_sum[:] = 0.0
                self._resid_norm[:] = 0.0
                self._count[:] = 0
            self._advisory_live = False
