"""Per-query telemetry harvest: the training substrate for online-learned
routing (ROADMAP open item 3).

Every completed query already carries the tuple the future online
retrainer needs — which route planned it, which clusters were probed,
whether admission degraded or shed it, what latency it achieved, how many
rerank rounds it took, and what its recall proxy measured.  Until now
those facts died with the batch.  :class:`HarvestRing` is a bounded ring
of structured per-query records appended from the engine's completion
funnel (O(1), lock-guarded tuple append — daemon-safe) and persisted as
**shards**:

* ``flush_npz(path)`` — columnar ``.npz`` (one array per field, probed
  clusters padded to a fixed width with -1) for bulk training loads;
* ``flush_jsonl(path)`` — one JSON object per record for ad-hoc
  ``jq``/pandas queries.

Both formats round-trip through :func:`load_npz` / plain ``json.loads``
back into the exact per-query tuples, which the tier-1 replay test
asserts field-by-field.
"""
from __future__ import annotations

import json
import threading
from collections import deque

import numpy as np

# record layout: one tuple per completed query, columnar at flush
FIELDS = ("req_id", "index", "trace_id", "t", "route", "nprobe", "status",
          "reason", "latency_s", "rerank_rounds", "quality", "shard",
          "clusters")

#: probed-cluster ids kept per record (padded with -1 in npz shards)
CLUSTER_SLOTS = 8


class HarvestRing:
    """Bounded ring of per-query telemetry records (see module doc)."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = int(capacity)
        self._dq: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.appended = 0          # lifetime appends (>= len when wrapped)

    def append(self, *, req_id: int, index: str, trace_id: int, t: float,
               route: str, nprobe: int, status: str, reason: str,
               latency_s: float, rerank_rounds: int, quality: float,
               shard: int, clusters=()) -> None:
        rec = (int(req_id), str(index), int(trace_id), float(t), str(route),
               int(nprobe), str(status), str(reason), float(latency_s),
               int(rerank_rounds), float(quality), int(shard),
               tuple(int(c) for c in clusters)[:CLUSTER_SLOTS])
        with self._lock:
            self._dq.append(rec)
            self.appended += 1

    def extend(self, recs) -> None:
        """Batched append of pre-built record tuples (FIELDS order, types
        already coerced) — one lock for a whole harvested batch.  The
        QualityMonitor hot path uses this; :meth:`append` stays the safe
        kwargs front door."""
        recs = list(recs)
        with self._lock:
            self._dq.extend(recs)
            self.appended += len(recs)

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    @property
    def dropped(self) -> int:
        """Records evicted by the ring bound."""
        with self._lock:
            return self.appended - len(self._dq)

    def records(self) -> list[dict]:
        with self._lock:
            rows = list(self._dq)
        return [dict(zip(FIELDS, r)) for r in rows]

    # -- persistence -------------------------------------------------------
    def flush_npz(self, path) -> dict:
        """Write a columnar shard; returns the column dict written."""
        with self._lock:
            rows = list(self._dq)
        n = len(rows)
        cl = np.full((n, CLUSTER_SLOTS), -1, np.int32)
        for i, r in enumerate(rows):
            cs = r[-1]
            if cs:
                cl[i, :len(cs)] = cs
        cols = {
            "req_id": np.array([r[0] for r in rows], np.int64),
            "index": np.array([r[1] for r in rows], dtype="<U32"),
            "trace_id": np.array([r[2] for r in rows], np.int64),
            "t": np.array([r[3] for r in rows], np.float64),
            "route": np.array([r[4] for r in rows], dtype="<U16"),
            "nprobe": np.array([r[5] for r in rows], np.int32),
            "status": np.array([r[6] for r in rows], dtype="<U16"),
            "reason": np.array([r[7] for r in rows], dtype="<U24"),
            "latency_s": np.array([r[8] for r in rows], np.float64),
            "rerank_rounds": np.array([r[9] for r in rows], np.int32),
            "quality": np.array([r[10] for r in rows], np.float32),
            "shard": np.array([r[11] for r in rows], np.int32),
            "clusters": cl,
        }
        np.savez_compressed(path, **cols)
        return cols

    def flush_jsonl(self, path) -> int:
        recs = self.records()
        with open(path, "w") as f:
            for r in recs:
                r = dict(r)
                r["clusters"] = list(r["clusters"])
                f.write(json.dumps(r) + "\n")
        return len(recs)


def load_npz(path) -> list[dict]:
    """Replay a columnar shard back into per-query record dicts — the
    consumption path open item 3's retrainer will use."""
    with np.load(path, allow_pickle=False) as z:
        cols = {k: z[k] for k in z.files}
    n = len(cols["req_id"])
    out = []
    for i in range(n):
        row = {k: cols[k][i].item() if cols[k].ndim == 1 else None
               for k in FIELDS if k != "clusters"}
        cl = cols["clusters"][i]
        row["clusters"] = tuple(int(c) for c in cl[cl >= 0])
        out.append(row)
    return out
