"""Host hot tiers (port of ``repro.storage.host_tier``: ``_plan_union``,
``FetchEvent``, ``TierStats``, the f32 ``TieredPostings`` and the int8
``QuantizedTieredPostings``).

The payload (f32 postings, or q8 codes, norms and centroids) and the ids
stay in host memory (numpy); each batch gathers only the union of its
probed clusters into PINNED host buffers and copies them to the device with
``non_blocking=True`` on the tier's own CUDA stream, so the copy of batch
i+1 overlaps the scan of batch i.  ``fetch`` returns a fetch record whose
``ready`` event the scan stream must wait on.  On the CPU the packed host
tensors are used as they are.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class FetchEvent:
    """Wall-clock stamps + union accounting of one fetch: host gather, then
    device stream.  ``union_bytes`` counts the payload of the real union rows
    only (no sentinel, no bucket padding).  The gather runs in three steps,
    each ending at its stamp: the union plan (``union_end``), the packed
    buffers' allocation (``alloc_end``), the row copies into them and the
    remap's pinning (``gather_end``); ``cpu_s`` is the gather's CPU time on
    the thread that ran it (``time.thread_time``)."""
    gather_start: float
    gather_end: float     # union gather materialized in pinned host memory
    stream_end: float     # packed tensors resident on the device
    rows: int             # packed rows streamed (incl. sentinel/pad rows)
    bytes: int
    clusters_requested: int = 0   # live probe slots across the batch
    clusters_union: int = 0       # after cross-query dedup (= gather rows)
    union_bytes: int = 0          # payload bytes of the deduped union
    union_end: float = 0.0        # _plan_union done
    alloc_end: float = 0.0        # packed host buffers allocated
    cpu_s: float = 0.0            # thread CPU seconds of the gather


@dataclasses.dataclass
class TierStats:
    bytes_streamed: int = 0
    union_bytes_streamed: int = 0
    batches: int = 0
    clusters_fetched: int = 0
    clusters_deduped: int = 0
    gather_s: float = 0.0          # cumulative host union-gather seconds
    stream_s: float = 0.0          # cumulative host->device stream seconds
    events: list = dataclasses.field(default_factory=list)
    max_events: int = 4096         # ring-bounded so serving daemons don't grow
    dropped_events: int = 0        # ring evictions: nonzero means ``events``
                                   # is a truncated window, not the full run

    def record(self, ev: FetchEvent) -> None:
        self.gather_s += ev.gather_end - ev.gather_start
        self.stream_s += ev.stream_end - ev.gather_end
        if len(self.events) >= self.max_events:
            drop = self.max_events // 2
            del self.events[:drop]
            self.dropped_events += drop
        self.events.append(ev)


def _plan_union(cids: np.ndarray, mask: Optional[np.ndarray],
                lut: np.ndarray, n_clusters: int,
                pad_rows: Optional[int], bucket: int):
    """Dedup the probed clusters across the batch and build the (B, P)
    remap into the packed row space.

    Returns (wanted (U,) unique cluster ids, u, rows, remap, live) where
    ``rows`` is U + 1 sentinel, rounded up to ``bucket`` and to at least
    ``pad_rows``; masked or negative probes remap to the sentinel row."""
    cids = np.asarray(cids)
    if mask is None:
        mask = np.ones_like(cids, dtype=bool)
    live = np.asarray(mask) & (cids >= 0)
    wanted = np.unique(cids[live])
    u = int(wanted.size)
    sentinel = u
    rows = max(u + 1, int(pad_rows or 0))
    rows = -(-rows // max(bucket, 1)) * max(bucket, 1)
    lut[wanted] = np.arange(u)
    remap = np.where(live, lut[np.clip(cids, 0, n_clusters - 1)], sentinel)
    return wanted, u, rows, remap.astype(np.int32), live


def _pinned_copy(host: tuple, device: torch.device, stream):
    """Copy pinned host tensors to ``device`` on ``stream`` and wait for
    the copies (the caller is the prefetch worker); returns (device
    tensors, ready event).  On the CPU the host tensors are returned."""
    if device.type != "cuda":
        return list(host), None
    with torch.cuda.stream(stream):
        dev = [h.to(device, non_blocking=True) for h in host]
        ready = torch.cuda.Event()
        ready.record(stream)
    ready.synchronize()
    return dev, ready


@dataclasses.dataclass
class F32Fetch:
    """The packed f32 union of one batch, on the tier's device."""
    postings: torch.Tensor    # (R, L, D) f32; sentinel/pad rows uninitialised
    ids: torch.Tensor         # (R, L) int32
    remap: torch.Tensor       # (B, P) int32 into the packed rows
    ready: Optional[torch.cuda.Event] = None   # copies done (CUDA only)
    event: Optional[FetchEvent] = None         # this fetch's own stamps

    def tensors(self) -> tuple:
        return (self.postings, self.ids, self.remap)


class TieredPostings:
    """Host-resident f32 posting store with batched device streaming.

    ``fetch`` gathers the union of the probed clusters once per batch and
    streams it: (packed postings (R, L, D), packed ids (R, L), remap
    (B, P)), R = union + 1 sentinel rounded up to ``bucket`` and to at
    least ``pad_rows``.  Masked or negative probes remap to the sentinel
    row; sentinel and pad rows carry ids -1 and an UNINITIALISED payload
    (reused pinned memory may hold any bits, NaN included), which every
    consumer masks by id.
    """

    quantized = False

    def __init__(self, postings: np.ndarray, posting_ids: np.ndarray,
                 epoch: int = 0, *, device: DeviceLike = None):
        self.postings = np.ascontiguousarray(postings, dtype=np.float32)
        self.posting_ids = np.ascontiguousarray(posting_ids, dtype=np.int32)
        self.epoch = int(epoch)
        self.device = resolve_device(device)
        self.released = False
        self.stats = TierStats()
        self._lut = np.zeros(self.postings.shape[0], dtype=np.int64)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def release(self) -> None:
        """Drop the host payload (idempotent); a later fetch raises."""
        self.released = True
        self.postings = None
        self.posting_ids = None
        self._lut = None

    @property
    def cluster_bytes(self) -> int:
        return int(self.postings[0].nbytes + self.posting_ids[0].nbytes)

    def fetch(self, cids: np.ndarray, mask: Optional[np.ndarray] = None,
              pad_rows: Optional[int] = None, bucket: int = 1) -> F32Fetch:
        """Union-gather the probed clusters' f32 rows and stream them (on
        CUDA: pinned buffers, the tier's stream, waited on here)."""
        if self.released:
            raise RuntimeError(
                f"fetch on released tier (epoch {self.epoch}): a batch was "
                f"routed to a retired index version")
        t0, c0 = time.perf_counter(), time.thread_time()
        wanted, u, rows, remap, live = _plan_union(
            cids, mask, self._lut, self.postings.shape[0], pad_rows, bucket)
        t_union = time.perf_counter()
        _, l, d = self.postings.shape
        pin = self.device.type == "cuda"
        packed = torch.empty((rows, l, d), dtype=torch.float32,
                             pin_memory=pin)
        packed_ids = torch.full((rows, l), -1, dtype=torch.int32,
                                pin_memory=pin)
        t_alloc = time.perf_counter()
        np.take(self.postings, wanted, axis=0, out=packed.numpy()[:u])
        np.take(self.posting_ids, wanted, axis=0,
                out=packed_ids.numpy()[:u])
        packed_remap = torch.from_numpy(remap)
        if pin:
            packed_remap = packed_remap.pin_memory()
        host = (packed, packed_ids, packed_remap)
        t1, cpu_s = time.perf_counter(), time.thread_time() - c0
        dev, ready = _pinned_copy(host, self.device, self._stream)
        t2 = time.perf_counter()
        nbytes = int(sum(h.numel() * h.element_size() for h in host[:2]))
        ev = _record_fetch(self.stats, FetchEvent(
            t0, t1, t2, rows, nbytes, clusters_requested=int(live.sum()),
            clusters_union=u, union_bytes=u * self.cluster_bytes,
            union_end=t_union, alloc_end=t_alloc, cpu_s=cpu_s))
        return F32Fetch(*dev, ready=ready, event=ev)


def _record_fetch(stats: TierStats, ev: FetchEvent) -> FetchEvent:
    stats.bytes_streamed += ev.bytes
    stats.union_bytes_streamed += ev.union_bytes
    stats.batches += 1
    stats.clusters_fetched += ev.clusters_requested
    stats.clusters_deduped += ev.clusters_union
    stats.record(ev)
    return ev


@dataclasses.dataclass
class QuantizedFetch:
    """The packed union of one batch, on the tier's device."""
    q8: torch.Tensor          # (R, L, D) int8
    scale: torch.Tensor       # (R, 1, 1) f32
    norm2: torch.Tensor       # (R, L) f32
    cents: torch.Tensor       # (R, D) f32 owning centroid per packed row
    ids: torch.Tensor         # (R, L) int32
    remap: torch.Tensor       # (B, P) int32 into the packed rows
    ready: Optional[torch.cuda.Event] = None   # copies done (CUDA only)
    event: Optional[FetchEvent] = None         # this fetch's own stamps

    def tensors(self) -> tuple:
        return (self.q8, self.scale, self.norm2, self.cents, self.ids,
                self.remap)


class QuantizedTieredPostings:
    """Host hot tier over the int8-residual payload (core/quantize.py).

    ``fetch`` speaks the union / sentinel / remap / bucket contract of the
    reference: sentinel and pad rows carry ids -1, zero norms and scale 1;
    their q8 payload stays uninitialized (never read past the id mask).
    """

    quantized = True

    def __init__(self, q8: np.ndarray, scale: np.ndarray, norm2: np.ndarray,
                 centroids: np.ndarray, posting_ids: np.ndarray,
                 epoch: int = 0, *, device: DeviceLike = None):
        self.q8 = np.ascontiguousarray(q8, dtype=np.int8)
        self.scale = np.ascontiguousarray(
            np.asarray(scale, np.float32).reshape(-1))
        self.norm2 = np.ascontiguousarray(np.asarray(norm2, np.float32))
        self.centroids = np.ascontiguousarray(
            np.asarray(centroids, np.float32))
        self.posting_ids = np.ascontiguousarray(posting_ids, dtype=np.int32)
        self.epoch = int(epoch)
        self.device = resolve_device(device)
        self.released = False
        self.stats = TierStats()
        self._lut = np.zeros(self.q8.shape[0], dtype=np.int64)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def release(self) -> None:
        self.released = True
        self.q8 = None
        self.scale = None
        self.norm2 = None
        self.centroids = None
        self.posting_ids = None
        self._lut = None

    @property
    def cluster_bytes(self) -> int:
        return int(self.q8[0].nbytes + self.norm2[0].nbytes
                   + self.posting_ids[0].nbytes + self.scale[0].nbytes
                   + self.centroids[0].nbytes)

    def nbytes(self) -> int:
        """Hot-tier resident payload bytes (the DRAM term of the cost model)."""
        return int(self.q8.nbytes + self.scale.nbytes + self.norm2.nbytes
                   + self.posting_ids.nbytes + self.centroids.nbytes)

    def fetch(self, cids: np.ndarray, mask: Optional[np.ndarray] = None,
              pad_rows: Optional[int] = None, bucket: int = 1
              ) -> QuantizedFetch:
        """Union-gather the probed clusters' quantized payload and stream it.

        On CUDA the gather writes straight into pinned host buffers, the
        copies run on the tier's stream, and this call (made on the prefetch
        worker) waits for them, so ``stream_end`` stamps the arrival and the
        pinned buffers outlive their copies."""
        if self.released:
            raise RuntimeError(
                f"fetch on released tier (epoch {self.epoch}): a batch was "
                f"routed to a retired index version")
        t0, c0 = time.perf_counter(), time.thread_time()
        wanted, u, rows, remap, live = _plan_union(
            cids, mask, self._lut, self.q8.shape[0], pad_rows, bucket)
        t_union = time.perf_counter()
        _, l, d = self.q8.shape
        pin = self.device.type == "cuda"
        packed_q8 = torch.empty((rows, l, d), dtype=torch.int8,
                                pin_memory=pin)
        packed_scale = torch.ones((rows,), dtype=torch.float32,
                                  pin_memory=pin)
        packed_norm2 = torch.zeros((rows, l), dtype=torch.float32,
                                   pin_memory=pin)
        packed_cent = torch.zeros((rows, d), dtype=torch.float32,
                                  pin_memory=pin)
        packed_ids = torch.full((rows, l), -1, dtype=torch.int32,
                                pin_memory=pin)
        t_alloc = time.perf_counter()
        np.take(self.q8, wanted, axis=0, out=packed_q8.numpy()[:u])
        np.take(self.scale, wanted, axis=0, out=packed_scale.numpy()[:u])
        np.take(self.norm2, wanted, axis=0, out=packed_norm2.numpy()[:u])
        np.take(self.centroids, wanted, axis=0, out=packed_cent.numpy()[:u])
        np.take(self.posting_ids, wanted, axis=0,
                out=packed_ids.numpy()[:u])
        packed_remap = torch.from_numpy(remap)
        if pin:
            packed_remap = packed_remap.pin_memory()
        host = (packed_q8, packed_scale, packed_norm2, packed_cent,
                packed_ids, packed_remap)
        t1, cpu_s = time.perf_counter(), time.thread_time() - c0
        dev, ready = _pinned_copy(host, self.device, self._stream)
        t2 = time.perf_counter()
        dev[1] = dev[1].reshape(rows, 1, 1)
        nbytes = int(sum(h.numel() * h.element_size() for h in host[:5]))
        ev = _record_fetch(self.stats, FetchEvent(
            t0, t1, t2, rows, nbytes, clusters_requested=int(live.sum()),
            clusters_union=u, union_bytes=u * self.cluster_bytes,
            union_end=t_union, alloc_end=t_alloc, cpu_s=cpu_s))
        return QuantizedFetch(*dev, ready=ready, event=ev)
