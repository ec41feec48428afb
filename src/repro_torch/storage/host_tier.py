"""Host hot tier over the int8-residual payload (port of
``repro.storage.host_tier``: ``_plan_union``, ``FetchEvent``, ``TierStats``
and ``QuantizedTieredPostings``).

The q8 codes, norms, ids and centroids stay in host memory (numpy); each
batch gathers only the union of its probed clusters into PINNED host
buffers and copies them to the device with ``non_blocking=True`` on the
tier's own CUDA stream, so the copy of batch i+1 overlaps the scan of
batch i.  ``fetch`` returns a :class:`QuantizedFetch` whose ``ready`` event
the scan stream must wait on.  On the CPU the packed host tensors are used
as they are.
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
    only (no sentinel, no bucket padding)."""
    gather_start: float
    gather_end: float     # union gather materialized in pinned host memory
    stream_end: float     # packed tensors resident on the device
    rows: int             # packed rows streamed (incl. sentinel/pad rows)
    bytes: int
    clusters_requested: int = 0   # live probe slots across the batch
    clusters_union: int = 0       # after cross-query dedup (= gather rows)
    union_bytes: int = 0          # payload bytes of the deduped union


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
        t0 = time.perf_counter()
        wanted, u, rows, remap, live = _plan_union(
            cids, mask, self._lut, self.q8.shape[0], pad_rows, bucket)
        _, l, d = self.q8.shape
        pin = self.device.type == "cuda"
        packed_q8 = torch.empty((rows, l, d), dtype=torch.int8,
                                pin_memory=pin)
        np.take(self.q8, wanted, axis=0, out=packed_q8.numpy()[:u])
        packed_scale = torch.ones((rows,), dtype=torch.float32,
                                  pin_memory=pin)
        np.take(self.scale, wanted, axis=0, out=packed_scale.numpy()[:u])
        packed_norm2 = torch.zeros((rows, l), dtype=torch.float32,
                                   pin_memory=pin)
        np.take(self.norm2, wanted, axis=0, out=packed_norm2.numpy()[:u])
        packed_cent = torch.zeros((rows, d), dtype=torch.float32,
                                  pin_memory=pin)
        np.take(self.centroids, wanted, axis=0, out=packed_cent.numpy()[:u])
        packed_ids = torch.full((rows, l), -1, dtype=torch.int32,
                                pin_memory=pin)
        np.take(self.posting_ids, wanted, axis=0,
                out=packed_ids.numpy()[:u])
        packed_remap = torch.from_numpy(remap)
        if pin:
            packed_remap = packed_remap.pin_memory()
        host = (packed_q8, packed_scale, packed_norm2, packed_cent,
                packed_ids, packed_remap)
        t1 = time.perf_counter()
        ready = None
        if pin:
            with torch.cuda.stream(self._stream):
                dev = [h.to(self.device, non_blocking=True) for h in host]
                ready = torch.cuda.Event()
                ready.record(self._stream)
            ready.synchronize()
        else:
            dev = list(host)
        t2 = time.perf_counter()
        dev[1] = dev[1].reshape(rows, 1, 1)
        nbytes = int(sum(h.numel() * h.element_size() for h in host[:5]))
        requested = int(live.sum())
        union_bytes = u * self.cluster_bytes
        self.stats.bytes_streamed += nbytes
        self.stats.union_bytes_streamed += union_bytes
        self.stats.batches += 1
        self.stats.clusters_fetched += requested
        self.stats.clusters_deduped += u
        self.stats.record(FetchEvent(t0, t1, t2, rows, nbytes,
                                     clusters_requested=requested,
                                     clusters_union=u,
                                     union_bytes=union_bytes))
        return QuantizedFetch(*dev, ready=ready)
