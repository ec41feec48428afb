"""Clustering-based (IVF/SPANN-style) index structures (port of
``repro.core.ivf``).

``IVFIndex`` is a dataclass of tensors: ``centroids`` (C, D), fixed-size
padded posting lists ``postings`` (C, L, D) with ``posting_ids`` (C, L)
(-1 = padding slot), and the optional int8 residual payload (``q8``,
``qscale``, ``qnorm2``) of ``core/quantize.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .distance import INF, dedup_topk, squared_l2_chunked, topk_smallest


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor            # (C, D) f32
    postings: torch.Tensor             # (C, L, D) f32 (pad: repeat last)
    posting_ids: torch.Tensor          # (C, L) int32, -1 = padding slot
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
    computed with one stable sort.
    """
    n, r = assign.shape
    d = x.shape[1]
    cl = assign.T.reshape(-1)                       # column-major order
    pts = np.tile(np.arange(n), r)
    keep = cl >= 0
    cl, pts = cl[keep], pts[keep]
    order = np.argsort(cl, kind="stable")
    cl, pts = cl[order], pts[order]
    starts = np.searchsorted(cl, np.arange(n_clusters))
    rank = np.arange(cl.size) - starts[cl]
    take = rank < cluster_len
    postings = np.zeros((n_clusters, cluster_len, d), dtype=np.float32)
    ids = np.full((n_clusters, cluster_len), -1, dtype=np.int32)
    postings[cl[take], rank[take]] = x[pts[take]]
    ids[cl[take], rank[take]] = pts[take]
    fill = np.minimum(np.bincount(cl, minlength=n_clusters), cluster_len)
    for c in np.nonzero((fill > 0) & (fill < cluster_len))[0]:
        postings[c, fill[c]:] = postings[c, fill[c] - 1]
    return postings, ids


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
