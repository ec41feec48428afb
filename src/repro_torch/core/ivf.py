"""Clustering-based (IVF/SPANN-style) index structures (port of
``repro.core.ivf``).

``IVFIndex`` is a dataclass of tensors: ``centroids`` (C, D), fixed-size
padded posting lists ``postings`` (C, L, D) with ``posting_ids`` (C, L)
(-1 = padding slot), the optional two-level centroid quantizer
(``group_centroids`` (G, D), ``group_members`` (G, Cg), -1 pad) of
:func:`make_group_quantizer`, and the optional int8 residual payload
(``q8``, ``qscale``, ``qnorm2``) of ``core/quantize.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .distance import INF, dedup_topk, squared_l2_chunked, topk_smallest
from .postings import posting_layout


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor            # (C, D) f32
    postings: torch.Tensor             # (C, L, D) f32 (pad: repeat last)
    posting_ids: torch.Tensor          # (C, L) int32, -1 = padding slot
    group_centroids: Optional[torch.Tensor] = None   # (G, D) f32
    group_members: Optional[torch.Tensor] = None     # (G, Cg) int32, -1 pad
    q8: Optional[torch.Tensor] = None          # (C, L, D) int8 residuals
    qscale: Optional[torch.Tensor] = None      # (C, 1, 1) f32
    qnorm2: Optional[torch.Tensor] = None      # (C, L) f32 s^2*||r8||^2

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cluster_len(self) -> int:
        return self.postings.shape[1]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, f.name)
                             for f in dataclasses.fields(self))
                   if t is not None)

    def to(self, device) -> "IVFIndex":
        move = lambda t: None if t is None else t.to(device)
        return IVFIndex(*(move(getattr(self, f.name))
                          for f in dataclasses.fields(self)))


def build_postings(x: np.ndarray, assign: np.ndarray, n_clusters: int,
                   cluster_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-size posting lists from a (N, R) closure assignment (numpy).

    A cluster's members are taken column by column of ``assign`` and in
    index order within a column; clusters larger than ``cluster_len`` keep
    their first ``cluster_len`` members, smaller ones pad the payload with
    their last member and id -1.  Same arrays as the reference's loop,
    computed with one stable sort (``core/postings.py``).
    """
    src, ids = posting_layout(assign, n_clusters, cluster_len)
    postings = x[np.maximum(src, 0)]
    postings[src < 0] = 0.0
    return postings, ids


def make_group_quantizer(centroids: np.ndarray, n_groups: int,
                         seed: int = 0, *, device=None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Two-level centroid quantizer: (group centroids (G, D) f32, members
    (G, Cg) int32, -1 pad), the members of each group in centroid order.
    Groups come from the unfused k-means, as in the reference."""
    from repro_torch.build.kmeans import kmeans

    gc, gassign, _ = kmeans(centroids, n_groups, iters=10, seed=seed,
                            fused=False, device=device)
    sizes = np.bincount(gassign, minlength=n_groups)
    members = np.full((n_groups, int(sizes.max())), -1, dtype=np.int32)
    fill = np.zeros(n_groups, dtype=np.int64)
    for cid, g in enumerate(gassign):
        members[g, fill[g]] = cid
        fill[g] += 1
    return gc.astype(np.float32), members


def brute_force_topk(x: torch.Tensor, queries: torch.Tensor, k: int,
                     chunk: int = 8192, query_chunk: int = 256
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact ground truth: (B, k) distances + ids over the raw vectors,
    computed over chunks of queries so the (chunk, N) tile stays bounded."""
    outs_d, outs_i = [], []
    for s in range(0, queries.shape[0], query_chunk):
        d = squared_l2_chunked(queries[s:s + query_chunk], x, chunk=chunk)
        vd, vi = topk_smallest(d, k)
        outs_d.append(vd)
        outs_i.append(vi)
    return torch.cat(outs_d), torch.cat(outs_i)


def search_flat(index: IVFIndex, queries: torch.Tensor, k: int,
                nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference (non-pruned, plain torch) IVF search: exact distances over
    the ``nprobe`` nearest clusters, deduplicated by id."""
    cd = squared_l2_chunked(queries, index.centroids)
    _, cids = topk_smallest(cd, nprobe)
    gathered = index.postings[cids]                  # (B, n, L, D)
    gids = index.posting_ids[cids]                   # (B, n, L)
    dist = torch.sum((gathered - queries[:, None, None, :]) ** 2, dim=-1)
    b = queries.shape[0]
    dist = dist.reshape(b, -1)
    gids = gids.reshape(b, -1)
    dist = torch.where(gids < 0, INF, dist)
    return dedup_topk(dist, gids, k)
