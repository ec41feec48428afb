"""Distance utilities shared by the ANNS core (torch port of
``repro.core.distance``).

All distances are squared L2.  Wherever the reference's tie order is part
of the contract (``jax.lax.top_k`` and ``jnp.argsort`` both put the lowest
index first among equal values), this module sorts with
``torch.sort(..., stable=True)``; ``torch.topk`` documents no tie order.
"""
from __future__ import annotations

import numpy as np
import torch

INF = float("inf")


def squared_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2, (N, D) x (M, D) -> (N, M), via the
    ||a||^2 - 2ab + ||b||^2 expansion (one matrix product), clamped >= 0."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).T
    return torch.clamp_min(a2 - 2.0 * (a @ b.T) + b2, 0.0)


def squared_l2_chunked(a: torch.Tensor, b: torch.Tensor,
                       chunk: int = 4096) -> torch.Tensor:
    """Pairwise distances computed over column chunks of ``b``."""
    if b.shape[0] <= chunk:
        return squared_l2(a, b)
    return torch.cat([squared_l2(a, b[s:s + chunk])
                      for s in range(0, b.shape[0], chunk)], dim=1)


def topk_smallest(d: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest along the last axis -> (values, indices), ascending,
    lowest index first among ties."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_candidates(vals, ids, k):
    pad = k - vals.shape[-1]
    if pad <= 0:
        return vals, ids
    shape = (*vals.shape[:-1], pad)
    vals = torch.cat([vals, vals.new_full(shape, INF)], dim=-1)
    ids = torch.cat([ids, ids.new_full(shape, -1)], dim=-1)
    return vals, ids


def dedup_topk(dists: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest with duplicate-id suppression: ascending per-id
    minimum distances, padded (+inf, -1)."""
    order = torch.argsort(dists, dim=-1, stable=True)
    sd = torch.gather(dists, -1, order)
    si = torch.gather(ids, -1, order)
    id_order = torch.argsort(si, dim=-1, stable=True)
    gid = torch.gather(si, -1, id_order)
    prev_same = torch.cat(
        [torch.zeros_like(gid[..., :1], dtype=torch.bool),
         gid[..., 1:] == gid[..., :-1]], dim=-1)
    dup = torch.zeros_like(prev_same).scatter(-1, id_order, prev_same)
    sd = torch.where(dup | (si < 0), INF, sd)
    vals, pos = topk_smallest(sd, min(k, sd.shape[-1]))
    out_ids = torch.gather(si, -1, pos)
    out_ids = torch.where(torch.isinf(vals), -1, out_ids)
    return _pad_candidates(vals, out_ids, k)


def merge_candidate_topk(dists: torch.Tensor, ids: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k merge over small candidate sets (the fused scan's output): one
    sort by distance plus an O(n^2) duplicate mask; past n = 256 the sort
    based :func:`dedup_topk` with the same contract takes over."""
    n = dists.shape[-1]
    if n > 256:
        return dedup_topk(dists, ids, k)
    order = torch.argsort(dists, dim=-1, stable=True)
    sd = torch.gather(dists, -1, order)
    si = torch.gather(ids, -1, order)
    same = si[..., :, None] == si[..., None, :]
    earlier = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                    device=dists.device), diagonal=-1)
    dup = torch.any(same & earlier, dim=-1)
    sd = torch.where(dup | (si < 0), INF, sd)
    vals, pos = topk_smallest(sd, min(k, n))
    out_ids = torch.gather(si, -1, pos)
    out_ids = torch.where(torch.isinf(vals), -1, out_ids)
    return _pad_candidates(vals, out_ids, k)


def recall_at_k(pred_ids, true_ids) -> float:
    """Mean recall@k between (B, k) predicted ids and (B, k) ground truth."""
    pred_ids = np.asarray(pred_ids)
    true_ids = np.asarray(true_ids)
    hits = 0
    for p, t in zip(pred_ids, true_ids):
        hits += len(set(p.tolist()) & set(t.tolist()))
    return hits / true_ids.size
