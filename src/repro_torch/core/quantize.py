"""int8 residual quantization of posting lists (port of
``repro.core.quantize.quantize_postings``).

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
