"""Public kernel entry points (port of ``repro.kernels.ops``).

Each call dispatches on the device of the tensors it is given: tensors on
the CPU go to the kernel's plain torch version, CUDA tensors go to the
hand-written CUDA kernel, which launches or raises.  There is no fallback
from a CUDA tensor to a plain version.  Launches are counted in
``kernels/cuda_lib.LAUNCHES``; the plain versions launch nothing.
"""
from __future__ import annotations

import torch

from . import ivf_scan as _ivf
from . import ivf_scan_q8 as _q8
from . import kmeans_assign as _assign
from . import kmeans_batched as _batched
from . import kmeans_mstep as _mstep
from . import pairwise_l2 as _pw


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def kmeans_assign_update(x: torch.Tensor, centroids: torch.Tensor):
    """Fused Lloyd E+M pass: (assign (N,) i32, min_dist (N,) f32,
    sums (K, D) f32, counts (K,) i32)."""
    if _on_cpu(x):
        return _assign.kmeans_assign_update_plain(x, centroids)
    return _assign.kmeans_assign_update_cuda(x, centroids)


def kmeans_mstep(sums: torch.Tensor, counts: torch.Tensor,
                 reseed: torch.Tensor) -> torch.Tensor:
    """Fused M-step finisher: new centroids with empty clusters reseeded."""
    if _on_cpu(sums):
        return _mstep.kmeans_mstep_plain(sums, counts, reseed)
    return _mstep.kmeans_mstep_cuda(sums, counts, reseed)


def kmeans_batched(x: torch.Tensor, pts: torch.Tensor, offs: torch.Tensor,
                   k: torch.Tensor, init: torch.Tensor, iters: int, *,
                   events=None):
    """Batched Lloyd k-means over the sub-problems x[pts[offs[s]:offs[s+1]]]
    (host int32 pts, offs, k, init): (assign (T,) i32, min_dist (T,) f32,
    cents (S, 16, D) f32, counts (S, 16) i32).  ``events``, a pair of CUDA
    events, brackets the kernel's launch (the plain version ignores it)."""
    if _on_cpu(x):
        return _batched.kmeans_batched_plain(x, pts, offs, k, init, iters)
    return _batched.kmeans_batched_cuda(x, pts, offs, k, init, iters,
                                        events=events)


def pairwise_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 (N, D) x (M, D) -> (N, M), clamped >= 0."""
    if _on_cpu(a):
        return _pw.pairwise_l2_plain(a, b)
    return _pw.pairwise_l2_cuda(a, b)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                  chunk: int = 16384):
    """The unfused k-means E-step: (assign (N,) int32, min_dist (N,) f32).

    Chunked over N to bound the (chunk, K) distance tile, which the
    ``pairwise_l2`` kernel computes; the argmin (first index among equal
    distances, as ``jnp.argmin``) and the min are plain ops outside the
    kernel, as the reference leaves them to XLA."""
    outs_a, outs_d = [], []
    for s in range(0, x.shape[0], chunk):
        d = pairwise_l2(x[s:s + chunk], centroids)
        outs_a.append(torch.argmin(d, dim=1).to(torch.int32))
        outs_d.append(torch.min(d, dim=1).values)
    return torch.cat(outs_a), torch.cat(outs_d)


def ivf_scan_q8_topk(q8, scale, norm2, centroids, posting_ids, cids, mask,
                     queries, *, k2: int):
    """Candidate-compressed int8-residual scan: ((B, k2) dists ascending,
    (B, k2) ids), unique by id, padded (+inf, -1)."""
    if _on_cpu(queries):
        return _q8.ivf_scan_q8_topk_plain(q8, scale, norm2, centroids,
                                          posting_ids, cids, mask, queries,
                                          k2=k2)
    return _q8.ivf_scan_q8_topk_cuda(q8, scale, norm2, centroids,
                                     posting_ids, cids, mask, queries, k2=k2)


def ivf_scan_topk(postings, posting_ids, cids, mask, queries, *, k2: int,
                  bq: int = 8):
    """Candidate-compressed f32 scan: ((B, k2) dists ascending, (B, k2)
    ids), unique by id, padded (+inf, -1)."""
    if _on_cpu(queries):
        return _ivf.ivf_scan_topk_plain(postings, posting_ids, cids, mask,
                                        queries, k2=k2, bq=bq)
    return _ivf.ivf_scan_topk_cuda(postings, posting_ids, cids, mask,
                                   queries, k2=k2, bq=bq)


def ivf_scan(postings, cids, mask, queries) -> torch.Tensor:
    """Legacy full-distance scan: (B, P, L) f32, masked probes +inf."""
    if _on_cpu(queries):
        return _ivf.ivf_scan_plain(postings, cids, mask, queries)
    return _ivf.ivf_scan_cuda(postings, cids, mask, queries)


def ivf_scan_clustermajor(postings, active, qsel, queries) -> torch.Tensor:
    """Cluster-major legacy scan: (A, L, B) f32, unselected (cluster,
    query) pairs +inf."""
    if _on_cpu(queries):
        return _ivf.ivf_scan_clustermajor_plain(postings, active, qsel,
                                                queries)
    return _ivf.ivf_scan_clustermajor_cuda(postings, active, qsel, queries)


def ivf_scan_q8(q8, scale, norm2, centroids, cids, mask, queries
                ) -> torch.Tensor:
    """Legacy int8-residual scan: (B, P, L) f32, masked probes +inf."""
    if _on_cpu(queries):
        return _q8.ivf_scan_q8_plain(q8, scale, norm2, centroids, cids, mask,
                                     queries)
    return _q8.ivf_scan_q8_cuda(q8, scale, norm2, centroids, cids, mask,
                                queries)
