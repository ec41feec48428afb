"""Streamed stage-2 shard assignment (port of ``repro.build.stream``): the
build's overlap pipeline, shard i+1's load hidden under shard i's assign.

  ``load``     -> the shard's host slice, pinned and copied to the device
                  with ``non_blocking=True`` on a side stream, on a
                  one-worker loader thread; ``stream_end`` is stamped once
                  the copy's event has completed, so it means "on the
                  device", not "enqueued";
  ``dispatch`` -> the current stream waits on that event, the shard tensor
                  is marked with ``record_stream`` (the allocator must not
                  hand its memory out while the assign reads it), and
                  ``closure_assign`` is launched; it issues no host
                  synchronisation, so this returns with the work in flight;
  ``harvest``  -> the only point that blocks (``.cpu()``), then the
                  shard's atomic ``.npz`` checkpoint (``os.replace``).

``run`` double-buffers: shard i+1's load is submitted right after shard
i's assign is dispatched.  Every stage is wall-clock stamped
(:class:`ShardStageTimes`), and :func:`shard_overlap_efficiency` measures
how much of shard i+1's load lands inside shard i's assign window.  On the
CPU the same stages run with no stream and no pinning, so the dispatch is
synchronous there.

A shard whose checkpoint exists short-circuits the whole chain (stamped
``resumed=True``), so a preempted build resumes at shard granularity and
hashes the same.  The delta-mode helpers (:func:`array_content_hash`,
:func:`make_shard_manifest`, :func:`plan_delta_shards`) are numpy only and
copies of the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core.spann_rules import closure_assign
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class ShardStageTimes:
    """Wall-clock stamps of one shard through the stage-2 pipeline."""
    shard: int
    rows: int = 0                  # vectors in this shard
    bytes: int = 0                 # host slice bytes loaded + streamed
    resumed: bool = False          # checkpoint hit: no load/assign ran
    load_start: float = 0.0
    load_end: float = 0.0          # host slice materialized
    stream_end: float = 0.0        # shard on the device (copy completed)
    assign_dispatch: float = 0.0
    assign_done: float = 0.0
    harvest_end: float = 0.0       # checkpoint written

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Loaded:
    shard: int
    path: str
    dev: Optional[torch.Tensor]
    ready: Optional[torch.cuda.Event]
    times: ShardStageTimes


class ShardAssignPipeline:
    """Double-buffered closure assignment over corpus shards.

    ``x`` is the host corpus; ``spans``/``paths`` give each shard's slice
    and checkpoint file; the centroids are copied to ``device`` once.
    ``run`` returns the per-shard stamps; the assignments land in the
    checkpoint files, which ``build_index`` concatenates as the elastic
    branch's."""

    def __init__(self, x: np.ndarray, centroids: np.ndarray,
                 spans: list, paths: list, *, eps: float,
                 max_replicas: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.x = x
        self.spans = list(spans)
        self.paths = list(paths)
        self.eps = float(eps)
        self.max_replicas = int(max_replicas)
        self.bytes_streamed = 0        # host slice bytes actually loaded
                                       # (resumed shards add nothing)
        self._cents_dev = torch.from_numpy(
            np.ascontiguousarray(centroids, np.float32)).to(self.device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._loader = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="shard-load")

    def close(self) -> None:
        """Release the loader thread."""
        self._loader.shutdown(wait=True)

    # -- stages ------------------------------------------------------------
    def _load(self, i: int) -> _Loaded:
        lo, hi = self.spans[i]
        path = self.paths[i]
        t = ShardStageTimes(shard=i, rows=hi - lo)
        if os.path.exists(path):           # task-granular resume
            t.resumed = True
            return _Loaded(i, path, None, None, t)
        t.load_start = time.perf_counter()
        host = torch.from_numpy(np.ascontiguousarray(self.x[lo:hi]))
        ready = None
        if self._copy_stream is None:
            t.load_end = time.perf_counter()
            dev = host.to(self.device)
        else:
            with torch.cuda.device(self.device):
                host = host.pin_memory()
                t.load_end = time.perf_counter()
                with torch.cuda.stream(self._copy_stream):
                    dev = host.to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
                ready.synchronize()        # on the device, not enqueued
        t.stream_end = time.perf_counter()
        t.bytes = int(host.numel() * host.element_size())
        self.bytes_streamed += t.bytes
        return _Loaded(i, path, dev, ready, t)

    def _dispatch(self, prep: _Loaded):
        """Launch the closure assign; returns with it in flight."""
        if prep.times.resumed:
            return None
        prep.times.assign_dispatch = time.perf_counter()
        if prep.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(prep.ready)
            prep.dev.record_stream(cur)
        return closure_assign(prep.dev, self._cents_dev, eps=self.eps,
                              max_replicas=self.max_replicas)

    def _harvest(self, prep: _Loaded, infl) -> ShardStageTimes:
        """Wait for the assign, checkpoint the shard atomically."""
        if prep.times.resumed:
            return prep.times
        a = infl.cpu().numpy()             # blocks until the assign lands
        prep.times.assign_done = time.perf_counter()
        tmp = prep.path + ".tmp.npz"       # .npz suffix: savez won't append
        np.savez(tmp, assign=a)
        os.replace(tmp, prep.path)
        prep.times.harvest_end = time.perf_counter()
        return prep.times

    # -- drivers -----------------------------------------------------------
    def run(self) -> list[ShardStageTimes]:
        """Pipelined pass over all shards: dispatch shard i, then submit
        shard i+1's load before harvesting i."""
        n = len(self.spans)
        if n == 0:
            return []
        stamps: list[ShardStageTimes] = []
        prep = self._loader.submit(self._load, 0).result()
        for i in range(n):
            infl = self._dispatch(prep)
            nxt = (self._loader.submit(self._load, i + 1)
                   if i + 1 < n else None)
            stamps.append(self._harvest(prep, infl))
            if nxt is not None:
                prep = nxt.result()
        return stamps

    def run_sequential(self) -> list[ShardStageTimes]:
        """Strictly serial chain (the A/B baseline)."""
        stamps = []
        for i in range(len(self.spans)):
            prep = self._load(i)
            infl = self._dispatch(prep)
            if infl is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            stamps.append(self._harvest(prep, infl))
        return stamps


def _get(t, name):
    return t[name] if isinstance(t, dict) else getattr(t, name)


def pair_overlaps(stamps: list) -> list[float]:
    """Per consecutive live shard pair: seconds of shard i+1's load+stream
    interval inside shard i's assign-in-flight window (negative when the
    intervals are disjoint).  Accepts ShardStageTimes or their asdict()
    form."""
    live = [t for t in stamps if not _get(t, "resumed")]
    return [
        min(_get(cur, "stream_end"), _get(prev, "assign_done"))
        - max(_get(cur, "load_start"), _get(prev, "assign_dispatch"))
        for prev, cur in zip(live, live[1:])
    ]


def shard_overlap_efficiency(stamps: list) -> float:
    """Fraction of load+stream seconds hidden under the previous shard's
    assign-in-flight window (0 = fully serial, ~1 = fully hidden)."""
    live = [t for t in stamps if not _get(t, "resumed")]
    tot = sum(max(0.0, _get(c, "stream_end") - _get(c, "load_start"))
              for c in live[1:])
    hidden = sum(max(0.0, o) for o in pair_overlaps(stamps))
    return hidden / tot if tot > 0 else 0.0


# --------------------------------------------------------------------------
# delta mode: content-addressed shard reuse (numpy only)
# --------------------------------------------------------------------------
def array_content_hash(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def make_shard_manifest(x: np.ndarray, spans: list, centroids: np.ndarray
                        ) -> dict:
    """Manifest of a completed stage 2: per-shard slice hashes and the
    centroid hash they were assigned against (JSON-serializable)."""
    return {
        "centroid_hash": array_content_hash(centroids),
        "shards": [
            {"lo": int(lo), "hi": int(hi),
             "hash": array_content_hash(x[lo:hi])}
            for lo, hi in spans
        ],
    }


@dataclasses.dataclass
class DeltaShardPlan:
    dirty: list                    # shard indices that must stream + assign
    reused: list                   # shard indices whose checkpoints hold
    bytes_dirty: int               # slice bytes the delta build will stream
    bytes_reused: int              # slice bytes reuse avoids streaming
    manifest: dict                 # manifest of the NEW build (all shards)


def plan_delta_shards(x: np.ndarray, spans: list, paths: list,
                      centroids: np.ndarray,
                      prev_manifest: Optional[dict],
                      trust_manifest: bool = True) -> DeltaShardPlan:
    """Diff the corpus against the previous build's manifest.

    A shard is reusable iff its span matches the manifest entry, the
    centroid set is unchanged and its checkpoint file exists.  Stale
    checkpoints of dirty shards are removed, so the pipeline's resume
    cannot serve outdated assignments.  ``trust_manifest`` carries a
    span-stable shard's stored hash forward without re-reading its slice
    (the corpus is append-only); False re-hashes it."""
    cent_hash = array_content_hash(centroids)
    cents_ok = (prev_manifest is not None and
                prev_manifest.get("centroid_hash") == cent_hash)
    prev_shards = (prev_manifest or {}).get("shards", [])
    dirty, reused, shard_ents = [], [], []
    bytes_dirty = bytes_reused = 0
    for i, ((lo, hi), path) in enumerate(zip(spans, paths)):
        nbytes = int(x[lo:hi].nbytes)
        prev = prev_shards[i] if cents_ok and i < len(prev_shards) else None
        span_ok = (prev is not None and prev["lo"] == lo and prev["hi"] == hi
                   and os.path.exists(path))
        if span_ok and not trust_manifest:
            span_ok = prev["hash"] == array_content_hash(x[lo:hi])
        if span_ok:
            shard_ents.append(prev)    # stored hash carried forward
            reused.append(i)
            bytes_reused += nbytes
        else:
            if os.path.exists(path):
                os.remove(path)        # stale: resume must not pick it up
            shard_ents.append({"lo": int(lo), "hi": int(hi),
                               "hash": array_content_hash(x[lo:hi])})
            dirty.append(i)
            bytes_dirty += nbytes
    return DeltaShardPlan(dirty=dirty, reused=reused,
                          bytes_dirty=bytes_dirty, bytes_reused=bytes_reused,
                          manifest={"centroid_hash": cent_hash,
                                    "shards": shard_ents})
