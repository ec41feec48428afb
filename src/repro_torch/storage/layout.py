"""Index data layout: metadata as files, cluster lists as raw blocks (Fig. 10).

``IndexMeta`` is the paper's metadata file — index name, per-cluster physical
location (device id + LBA), pruning-model blob paths, and the centroid index —
small enough to live in DRAM at runtime (it is JSON + npz on the metadata
device).

``plan_striping`` converts an arena extent map into the permutation that
shards the posting tensor over the ``model`` mesh axis: cluster i is placed on
mesh shard ``extent.device % n_shards``, and within a shard the clusters are
densely packed in extent order.  The serving engine looks up clusters through
``shard_of``/``slot_of`` so the logical cluster id never needs to equal its
physical position — exactly the indirection the paper's metadata map provides.

``ReplicaMap`` implements the §6.2 hot-spot mitigation: a few redundant copies
of (hot) cluster lists placed on other devices; query load is hashed across
replicas, and a replica is the fallback when a shard fails (fault tolerance).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .arena import ChunkArena, Extent, LBA_BYTES


@dataclasses.dataclass
class IndexMeta:
    name: str
    n_clusters: int
    cluster_len: int
    dim: int
    dtype: str
    extents: List[Extent]
    model_files: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "IndexMeta":
        d = json.loads(s)
        d["extents"] = [Extent(**e) for e in d["extents"]]
        return IndexMeta(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "IndexMeta":
        with open(path) as f:
            return IndexMeta.from_json(f.read())


@dataclasses.dataclass
class Striping:
    """cluster id -> (shard, slot) placement + inverse permutation.

    ``perm`` reorders the logical posting tensor (C, L, D) so that
    ``postings[perm]`` is shard-major: shard s owns rows
    [s*rows_per_shard, (s+1)*rows_per_shard).  ``cluster_to_row[i]`` is the
    row of logical cluster i after permutation.
    """

    n_shards: int
    rows_per_shard: int
    perm: np.ndarray            # (C_padded,) row -> logical cluster (-1 pad)
    cluster_to_row: np.ndarray  # (C,) logical cluster -> row

    def shard_of(self, cluster: np.ndarray) -> np.ndarray:
        return self.cluster_to_row[cluster] // self.rows_per_shard


def plan_striping(
    n_clusters: int,
    n_shards: int,
    extents: Optional[Sequence[Extent]] = None,
) -> Striping:
    """Plan the shard-major permutation of the posting tensor.

    With an arena extent map, clusters follow their physical device placement
    (device d -> shard d % n_shards).  Without one, round-robin striping (the
    arena's allocation order is round-robin anyway).  Shards are padded to
    equal row counts with -1 (payload rows are duplicated data, masked by
    posting id -1 during search).
    """
    if extents is not None:
        shard_of = np.array([e.device % n_shards for e in extents])
    else:
        shard_of = np.arange(n_clusters) % n_shards
    members = [np.nonzero(shard_of == s)[0] for s in range(n_shards)]
    rows = max(len(m) for m in members)
    perm = np.full(n_shards * rows, -1, dtype=np.int64)
    c2r = np.zeros(n_clusters, dtype=np.int64)
    for s, m in enumerate(members):
        perm[s * rows : s * rows + len(m)] = m
        c2r[m] = s * rows + np.arange(len(m))
    return Striping(n_shards, rows, perm, c2r)


def apply_striping(
    striping: Striping, postings: np.ndarray, posting_ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Materialize the shard-major posting tensor ((S*rows, L, D), (S*rows, L)).

    Pad rows replicate row 0's payload with ids=-1 (never contribute)."""
    perm = striping.perm
    safe = np.maximum(perm, 0)
    p = postings[safe]
    ids = np.where(perm[:, None] >= 0, posting_ids[safe], -1)
    return p, ids


@dataclasses.dataclass
class ReplicaMap:
    """Redundant cluster copies across shards (§6.2 die-conflict mitigation
    + shard-failure fallback).

    replicas[i] lists the shards holding cluster i; entry 0 is the primary.
    """

    replicas: np.ndarray  # (C, R) int32, -1 = no replica in that slot

    @property
    def n_replicas(self) -> int:
        return self.replicas.shape[1]

    def route(self, cluster: np.ndarray, salt: np.ndarray) -> np.ndarray:
        """Pick a serving shard per (cluster, query-salt): load balancing by
        hashing across live replica slots."""
        r = self.replicas[cluster]
        n_live = (r >= 0).sum(axis=-1)
        pick = salt % np.maximum(n_live, 1)
        return np.take_along_axis(r, pick[..., None], axis=-1)[..., 0]

    def failover(self, failed_shards: Sequence[int]) -> "ReplicaMap":
        """Return a map with failed shards masked out; clusters whose every
        replica failed keep -1 (reported lost by the caller)."""
        mask = np.isin(self.replicas, np.asarray(failed_shards, dtype=np.int32))
        rep = np.where(mask, -1, self.replicas)
        # compact: primaries first
        order = np.argsort(rep < 0, axis=1, kind="stable")
        return ReplicaMap(np.take_along_axis(rep, order, axis=1))

    def lost_clusters(self) -> np.ndarray:
        return np.nonzero((self.replicas < 0).all(axis=1))[0]


def make_replica_map(
    n_clusters: int,
    n_shards: int,
    striping: Striping,
    hot_clusters: Optional[np.ndarray] = None,
    n_replicas: int = 2,
) -> ReplicaMap:
    """Primary from striping; hot clusters get n_replicas-1 extra copies on
    (primary + j * stride) shards."""
    rep = np.full((n_clusters, n_replicas), -1, dtype=np.int32)
    rep[:, 0] = striping.shard_of(np.arange(n_clusters))
    if hot_clusters is not None and n_shards > 1:
        stride = max(1, n_shards // n_replicas)
        for j in range(1, n_replicas):
            rep[hot_clusters, j] = (rep[hot_clusters, 0] + j * stride) % n_shards
    return ReplicaMap(rep)
