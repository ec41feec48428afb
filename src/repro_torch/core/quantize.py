"""int8 residual quantization of posting lists (port of
``repro.core.quantize``: ``quantize_postings``, ``attach_quantized``,
``ivf_scan_quantized`` and ``search_flat_quantized``).

Each cluster's residuals to its own centroid are quantized symmetrically:

    q8 = clip(round(r / s), -127, 127),   s = max(max|r| / 127, 1e-12)

and ``norm2 = s^2 ||q8||^2`` is precomputed per slot, so the scan's distance
stays closed-form (see ``kernels/ivf_scan_q8.py``).  Dead slots (id < 0) are
excluded from the scale and carry a zero code and a zero norm.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .distance import INF
from .ivf import IVFIndex


@dataclasses.dataclass
class QuantizedPostings:
    q8: torch.Tensor       # (C, L, D) int8
    scale: torch.Tensor    # (C, 1, 1) f32 per-cluster scale
    norm2: torch.Tensor    # (C, L) f32 s^2 * ||q8||^2


def quantize_postings(postings: torch.Tensor, centroids: torch.Tensor,
                      posting_ids: Optional[torch.Tensor] = None
                      ) -> QuantizedPostings:
    """Quantize padded posting lists against their own centroids; with
    ``posting_ids`` given, dead slots (id < 0) are masked out of the scale
    and get zero codes and norms.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    p = postings.to(torch.float32)
    r = p - centroids.to(torch.float32)[:, None, :]
    if posting_ids is not None:
        live = (posting_ids >= 0)[:, :, None]
        r = torch.where(live, r, 0.0)
    amax = torch.amax(torch.abs(r), dim=(1, 2), keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q8 = torch.clamp(torch.round(r / scale), -127, 127).to(torch.int8)
    norm2 = (scale ** 2)[:, :, 0] * torch.sum(q8.to(torch.float32) ** 2,
                                              dim=-1)
    return QuantizedPostings(q8=q8, scale=scale, norm2=norm2)


def attach_quantized(index: IVFIndex,
                     qp: Optional[QuantizedPostings] = None) -> IVFIndex:
    """A copy of ``index`` carrying its int8-residual payload (quantized
    here, dead slots masked out of the scale, when ``qp`` is omitted); it
    serves with ``SearchConfig(tier="q8")``."""
    if qp is None:
        qp = quantize_postings(index.postings, index.centroids,
                               index.posting_ids)
    return dataclasses.replace(index, q8=qp.q8, qscale=qp.scale,
                               qnorm2=qp.norm2)


def ivf_scan_quantized(qp: QuantizedPostings, centroids: torch.Tensor,
                       cids: torch.Tensor, mask: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """(B, P, L) f32 distances against the int8 residual postings (plain
    torch, as in the reference); masked probes +inf."""
    q = queries.to(torch.float32)
    safe = torch.clamp(cids.long(), 0, qp.q8.shape[0] - 1)
    g8 = qp.q8[safe].to(torch.float32)                   # (B, P, L, D)
    s = qp.scale[safe][:, :, :, 0]                       # (B, P, 1)
    qc = q[:, None, :] - centroids[safe]                 # (B, P, D)
    cross = torch.einsum("bpd,bpld->bpl", qc, g8)
    d = (torch.sum(qc * qc, dim=-1)[:, :, None] - 2.0 * s * cross
         + qp.norm2[safe])
    d = torch.clamp_min(d, 0.0)
    return torch.where(mask.bool()[:, :, None], d, INF)


def search_flat_quantized(index: IVFIndex, qp: QuantizedPostings,
                          queries: torch.Tensor, k: int, nprobe: int,
                          fused: bool = True, use_kernel: bool = False):
    """Quantized counterpart of ``core.ivf.search_flat``: the ``nprobe``
    nearest clusters, all probed.  ``fused`` keeps (B, ~2k) unique-by-id
    candidates (``use_kernel``: through ``ops.ivf_scan_q8_topk``, else its
    oracle) and merges to k; otherwise the legacy (B, P, L) distances and a
    dedup top-k."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import ivf_scan_q8_topk_ref

    from .distance import dedup_topk, merge_candidate_topk, \
        squared_l2_chunked, topk_smallest
    from .search import _auto_ncand

    cd = squared_l2_chunked(queries, index.centroids)
    _, cids = topk_smallest(cd, nprobe)
    mask = torch.ones(cids.shape, dtype=torch.bool, device=cids.device)
    if fused:
        k2 = _auto_ncand(k)
        scan = kops.ivf_scan_q8_topk if use_kernel else ivf_scan_q8_topk_ref
        cand_d, cand_i = scan(qp.q8, qp.scale, qp.norm2, index.centroids,
                              index.posting_ids, cids.to(torch.int32), mask,
                              queries, k2=k2)
        return merge_candidate_topk(cand_d, cand_i, k)
    dist = ivf_scan_quantized(qp, index.centroids, cids, mask, queries)
    gids = index.posting_ids[cids]
    dist = torch.where(gids < 0, INF, dist)
    b = queries.shape[0]
    return dedup_topk(dist.reshape(b, -1), gids.reshape(b, -1), k)
