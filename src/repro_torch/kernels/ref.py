"""Plain torch oracles for the port's kernels (torch counterparts of
``repro.kernels.ref``).  They state each kernel's output contract in the
fewest tensor operations; the kernel modules' plain versions follow the
kernels' own structure instead."""
from __future__ import annotations

import torch

from repro_torch.core.distance import INF, dedup_topk


def pairwise_l2_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) squared L2, f32 accumulation, >= 0."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).T
    return torch.clamp_min(a2 - 2.0 * (a @ b.T) + b2, 0.0)


def kmeans_assign_update_ref(x: torch.Tensor, centroids: torch.Tensor):
    """Oracle for the fused assign-and-accumulate kernel: (assign (N,) i32,
    min_dist (N,) f32, sums (K, D) f32, counts (K,) f32); the argmin takes
    the first index among equal distances."""
    d = pairwise_l2_ref(x, centroids)
    a = torch.argmin(d, dim=1)
    md = torch.gather(d, 1, a[:, None])[:, 0]
    k = centroids.shape[0]
    oh = torch.nn.functional.one_hot(a, k).to(torch.float32)
    sums = oh.T @ x.to(torch.float32)
    counts = oh.sum(dim=0)
    return a.to(torch.int32), md, sums, counts


def kmeans_mstep_ref(sums: torch.Tensor, counts: torch.Tensor,
                     reseed: torch.Tensor) -> torch.Tensor:
    """Oracle for the fused M-step: means, and empty cluster k takes
    reseed[rank(k)] where rank(k) counts the empty clusters before k."""
    counts = counts.to(torch.float32)
    empty = counts <= 0.0
    e = empty.to(torch.int64)
    rank = torch.cumsum(e, dim=0) - e
    mean = sums.to(torch.float32) / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(empty[:, None], reseed.to(torch.float32)[rank], mean)


def ivf_scan_q8_topk_ref(q8, scale, norm2, centroids, posting_ids, cids,
                         mask, queries, k2: int):
    """Oracle for the fused q8 scan: ((B, k2) ascending dists, (B, k2) ids),
    unique by id with the per-id minimum, padded (+inf, -1)."""
    q = queries.to(torch.float32)
    safe = torch.clamp(cids.long(), 0, q8.shape[0] - 1)
    g8 = q8[safe].to(torch.float32)                      # (B, P, L, D)
    s = scale[safe][:, :, :, 0]                          # (B, P, 1)
    qc = q[:, None, :] - centroids[safe]                 # (B, P, D)
    cross = torch.einsum("bpd,bpld->bpl", qc, g8)
    d = torch.sum(qc * qc, dim=-1)[:, :, None] - 2.0 * s * cross + norm2[safe]
    d = torch.clamp_min(d, 0.0)
    d = torch.where(mask.bool()[:, :, None], d, INF)
    ids = posting_ids[safe]
    d = torch.where(ids < 0, INF, d)
    b = queries.shape[0]
    return dedup_topk(d.reshape(b, -1), ids.reshape(b, -1), k2)


def ivf_scan_ref(postings, cids, mask, queries) -> torch.Tensor:
    """Oracle for the legacy scan: (B, P, L) squared L2 from each query to
    the rows of its probed clusters (cids clamped), masked probes +inf."""
    q = queries.to(torch.float32)
    safe = torch.clamp(cids.long(), 0, postings.shape[0] - 1)
    g = postings[safe].to(torch.float32)                 # (B, P, L, D)
    d = (torch.sum(q * q, dim=-1)[:, None, None]
         - 2.0 * torch.einsum("bd,bpld->bpl", q, g)
         + torch.sum(g * g, dim=-1))
    d = torch.clamp_min(d, 0.0)
    return torch.where(mask.bool()[:, :, None], d, INF)


def ivf_scan_topk_ref(postings, posting_ids, cids, mask, queries, k2: int):
    """Oracle for the fused f32 scan: full scan then dedup-top-k2:
    ((B, k2) ascending dists, (B, k2) ids), unique by id with the per-id
    minimum, padded (+inf, -1)."""
    d = ivf_scan_ref(postings, cids, mask, queries)
    safe = torch.clamp(cids.long(), 0, postings.shape[0] - 1)
    ids = posting_ids[safe]
    d = torch.where(ids < 0, INF, d)
    b = queries.shape[0]
    return dedup_topk(d.reshape(b, -1), ids.reshape(b, -1), k2)
