"""mmap-backed simulated flash tier for full-precision re-rank reads (a copy
of ``repro.storage.flash_tier``; the re-rank reads stay numpy on the host).

The quantized serving default (paper §2 cost thesis) demotes the
f32 vectors out of host DRAM: the hot tier keeps only the int8-residual
payload (storage/host_tier.QuantizedTieredPostings), and the full-precision
copy lives here — a file-backed ``np.memmap`` standing in for the raw-block
SSD tier, addressed by GLOBAL vector id (re-rank candidates arrive as
fused-topk ids, not cluster slots, so the flash layout is id-major rather
than cluster-major).

Reads are stamped (``ReadEvent``) the same way ``TieredPostings`` stamps
fetches, so the serving pipeline can *measure* that re-rank I/O for batch i
lands inside batch i+1's scan-in-flight window (the FusionANNS/Kioxia
overlap argument) instead of asserting it.  Space is accounted in row-block
extents against an arena when one is given: any object with
``allocate_index(name, n_extents, extent_bytes)`` and ``release_index(name)``
(the reference's ``ChunkArena`` has both) — the flash tier is a tenant of
the same raw-block device budget as the posting shards.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ReadEvent:
    """Wall-clock stamps + accounting of one flash read burst."""
    start: float
    end: float
    rows: int             # unique rows actually read
    bytes: int
    requested: int = 0    # ids requested before cross-query dedup


@dataclasses.dataclass
class FlashStats:
    reads: int = 0
    rows_read: int = 0
    bytes_read: int = 0
    rows_requested: int = 0
    read_s: float = 0.0
    events: list = dataclasses.field(default_factory=list)
    max_events: int = 4096
    dropped_events: int = 0

    def reset(self) -> None:
        self.reads = 0
        self.rows_read = 0
        self.bytes_read = 0
        self.rows_requested = 0
        self.read_s = 0.0
        self.events.clear()
        self.dropped_events = 0

    def record(self, ev: ReadEvent) -> None:
        self.read_s += ev.end - ev.start
        if len(self.events) >= self.max_events:
            drop = self.max_events // 2
            del self.events[:drop]
            self.dropped_events += drop
        self.events.append(ev)


# rows per arena extent: big enough that the extent table stays small, small
# enough that partial tail blocks don't waste a chunk.
ROWS_PER_EXTENT = 4096


class FlashTier:
    """Full-precision vectors behind a file-backed mmap, addressed by id.

    ``epoch`` mirrors the lifecycle contract of ``TieredPostings``: each
    index version gets its own flash file, released when the version
    manager retires the epoch.
    """

    def __init__(self, vectors: np.ndarray, path: Optional[str] = None,
                 *, arena=None,
                 name: str = "flash", epoch: int = 0):
        x = np.ascontiguousarray(np.asarray(vectors, np.float32))
        self.n, self.dim = x.shape
        self.epoch = int(epoch)
        self.name = str(name)
        self.released = False
        self.stats = FlashStats()
        if path is None:
            fd, path = tempfile.mkstemp(
                prefix=f"{self.name}-e{self.epoch}-", suffix=".f32")
            os.close(fd)
        self.path = path
        # a plain write and fsync: both release the interpreter lock, where
        # a memmap's flush (msync) holds it for the whole sync, stalling a
        # serving process's other threads (a live rebuild builds an epoch's
        # flash file while the engine's poller serves)
        with open(path, "wb") as f:
            f.write(memoryview(x).cast("B"))
            f.flush()
            os.fsync(f.fileno())
        # reopen read-only: serving must never scribble on the flash copy
        self._mm = np.memmap(path, dtype=np.float32, mode="r",
                             shape=(self.n, self.dim))
        self._arena = arena
        self.extents: list = []
        if arena is not None:
            n_ext = -(-self.n // ROWS_PER_EXTENT)
            self.extents = arena.allocate_index(
                f"{self.name}-e{self.epoch}", n_ext,
                ROWS_PER_EXTENT * self.row_bytes)

    @property
    def row_bytes(self) -> int:
        return self.dim * 4

    @property
    def nbytes(self) -> int:
        """Live payload bytes (the SSD term of the cost model)."""
        return self.n * self.row_bytes

    def release(self) -> None:
        """Drop the mmap, delete the backing file, return arena chunks.
        Idempotent; a read after release fails loudly."""
        if self.released:
            return
        self.released = True
        self._mm = None
        if self._arena is not None:
            self._arena.release_index(f"{self.name}-e{self.epoch}")
            self._arena = None
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def read(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Read the f32 rows for a batch of candidate ids.

        ``ids`` is any-shape int; negative ids (candidate padding) are
        skipped.  Returns (uids (U,) the unique non-negative ids read,
        rows (U, D) f32) — callers remap through uids, mirroring the hot
        tier's union-dedup so a candidate shared across queries costs one
        flash read per burst.
        """
        return self.read_stamped(ids)[:2]

    def read_stamped(self, ids: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, ReadEvent]:
        """:meth:`read`, with the read's own stamps: (uids, rows, event).
        A caller with reads in flight on other threads takes its stamps
        from here, not from ``stats.events``, whose last entry may be
        another read's."""
        if self.released:
            raise RuntimeError(
                f"read on released flash tier (epoch {self.epoch})")
        t0 = time.perf_counter()
        flat = np.asarray(ids).reshape(-1)
        requested = int((flat >= 0).sum())
        uids = np.unique(flat[flat >= 0]).astype(np.int64)
        rows = np.array(self._mm[uids])  # materialize: touch the "device"
        t1 = time.perf_counter()
        nb = int(rows.nbytes)
        self.stats.reads += 1
        self.stats.rows_read += int(uids.size)
        self.stats.bytes_read += nb
        self.stats.rows_requested += requested
        ev = ReadEvent(t0, t1, int(uids.size), nb, requested=requested)
        self.stats.record(ev)
        return uids, rows, ev
