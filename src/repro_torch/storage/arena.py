"""Chunk-based free-list allocator over raw block devices (paper §4.2).

The paper's space-allocation insight: because every cluster list is padded to
a fixed size, SSD space can be managed with a trivial, fragmentation-free
chunk allocator (64 MB chunks by default) instead of a filesystem.  Each index
partitions its chunks into consecutive block ranges sized to one cluster list
and assigns each range to a single cluster, so reading one cluster is one
contiguous I/O on one device.

This module is the host-side bookkeeping tier of the device adaptation: the
"devices" are the posting shards (one per `model`-axis device on the serving
mesh, standing in for the 12-SSD array), and the extent map it produces is the
cluster->(shard, offset) layout consumed by ``storage.layout`` when the
posting tensor is sharded.  It also supports multi-index hosting — several
indexes co-resident on one all-flash node — which is how 40 machines replace
35k cores in the deployment (§6.1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

LBA_BYTES = 4096  # logical block size


@dataclasses.dataclass(frozen=True)
class Extent:
    """A contiguous block range on one device: one cluster list."""

    device: int
    lba: int          # first logical block
    n_blocks: int

    @property
    def nbytes(self) -> int:
        return self.n_blocks * LBA_BYTES


class OutOfSpace(RuntimeError):
    pass


class ChunkArena:
    """Unified chunk-based free-list allocator for all indexes on a node.

    Chunks are fixed-size (default 64 MB) regions carved from each device.
    Allocation requests take a cluster-list size and a count; the arena hands
    back extents that never cross a chunk (hence never cross a device), and
    recycles whole chunks when an index is deleted.
    """

    def __init__(
        self,
        n_devices: int,
        device_bytes: int,
        chunk_bytes: int = 64 << 20,
    ):
        if chunk_bytes % LBA_BYTES:
            raise ValueError("chunk_bytes must be LBA-aligned")
        self.n_devices = n_devices
        self.device_bytes = device_bytes
        self.chunk_bytes = chunk_bytes
        self.chunks_per_device = device_bytes // chunk_bytes
        # free list of (device, chunk_idx); device-round-robin order so
        # consecutive allocations stripe across the array (bandwidth)
        self._free: List[Tuple[int, int]] = [
            (d, c)
            for c in range(self.chunks_per_device)
            for d in range(n_devices)
        ]
        self._free.reverse()  # pop() yields round-robin order
        self._owned: Dict[str, List[Tuple[int, int]]] = {}

    # -- stats ---------------------------------------------------------------
    @property
    def free_bytes(self) -> int:
        return len(self._free) * self.chunk_bytes

    @property
    def used_bytes(self) -> int:
        return sum(len(v) for v in self._owned.values()) * self.chunk_bytes

    def indexes(self) -> List[str]:
        return list(self._owned)

    # -- alloc / free ----------------------------------------------------------
    def allocate_index(
        self, name: str, n_clusters: int, cluster_bytes: int
    ) -> List[Extent]:
        """Allocate extents for an index's cluster lists.

        Each extent is LBA-aligned, chunk-resident and device-contiguous.
        Raises OutOfSpace (allocating nothing) if capacity is insufficient.
        """
        if name in self._owned:
            raise ValueError(f"index {name!r} already allocated")
        blocks_per_cluster = -(-cluster_bytes // LBA_BYTES)
        aligned_bytes = blocks_per_cluster * LBA_BYTES
        per_chunk = self.chunk_bytes // aligned_bytes
        if per_chunk == 0:
            raise ValueError("cluster larger than a chunk")
        need_chunks = -(-n_clusters // per_chunk)
        if need_chunks > len(self._free):
            raise OutOfSpace(
                f"{name}: need {need_chunks} chunks, {len(self._free)} free"
            )
        chunks = [self._free.pop() for _ in range(need_chunks)]
        self._owned[name] = chunks
        extents: List[Extent] = []
        for i in range(n_clusters):
            dev, chunk = chunks[i // per_chunk]
            slot = i % per_chunk
            lba = (chunk * self.chunk_bytes + slot * aligned_bytes) // LBA_BYTES
            extents.append(Extent(dev, lba, blocks_per_cluster))
        return extents

    def release_index(self, name: str) -> None:
        """Recycle all chunks of an index (whole-chunk granularity)."""
        chunks = self._owned.pop(name, None)
        if chunks is None:
            raise KeyError(name)
        self._free.extend(reversed(chunks))

    def validate(self) -> None:
        """Invariant check (used by property tests): no chunk double-owned,
        owned + free == total."""
        seen = set()
        for name, chunks in self._owned.items():
            for c in chunks:
                if c in seen:
                    raise AssertionError(f"chunk {c} owned twice ({name})")
                seen.add(c)
        for c in self._free:
            if c in seen:
                raise AssertionError(f"chunk {c} both free and owned")
            seen.add(c)
        total = self.n_devices * self.chunks_per_device
        if len(seen) != total:
            raise AssertionError(f"chunk leak: {len(seen)} != {total}")
