"""SPANN-inherited rules (port of ``repro.core.spann_rules``): fixed-epsilon
pruning (Eq. 1) and closure multi-cluster assignment with the RNG rule."""
from __future__ import annotations

import torch

from .distance import squared_l2, topk_smallest


def fixed_eps_nprobe(cdists: torch.Tensor, eps: float, nmax: int
                     ) -> torch.Tensor:
    """Eq. 1: probe cluster j iff Dist(q, c_j) <= (1+eps) * Dist(q, c_1), in
    the squared domain.  cdists (B, nmax) ascending -> (B,) int32."""
    thr = (1.0 + eps) ** 2 * cdists[:, :1]
    keep = cdists <= thr
    return torch.clamp_max(torch.sum(keep, dim=1), nmax).to(torch.int32)


def closure_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                   eps: float = 0.1, max_replicas: int = 4,
                   rng_rule: bool = True, chunk: int = 8192) -> torch.Tensor:
    """Closure multi-cluster assignment: each vector goes to up to
    ``max_replicas`` nearest clusters within (1+eps) of the nearest, kept by
    the RNG rule (c_j survives iff for every kept c_m, Dist(x, c_j) <=
    Dist(c_m, c_j)).  Returns (N, max_replicas) int32, -1 padded; column 0
    is the nearest cluster.  The distance tile is a plain matrix product."""
    r = max_replicas

    def assign_chunk(xc):
        cd, cand = topk_smallest(squared_l2(xc, centroids), r)   # (n, R)
        in_window = cd <= (1.0 + eps) ** 2 * cd[:, :1]
        if not rng_rule:
            keep = in_window
        else:
            cc = centroids[cand]                                  # (n, R, D)
            ccd = torch.sum((cc[:, :, None, :] - cc[:, None, :, :]) ** 2,
                            dim=-1)                               # (n, R, R)
            keep = torch.zeros_like(in_window)
            keep[:, 0] = True
            for j in range(1, cd.shape[1]):
                occluded = torch.any(keep & (ccd[:, :, j] < cd[:, j:j + 1]),
                                     dim=1)
                keep[:, j] = in_window[:, j] & ~occluded
        return torch.where(keep, cand, -1).to(torch.int32)

    if x.shape[0] <= chunk:
        return assign_chunk(x)
    return torch.cat([assign_chunk(x[s:s + chunk])
                      for s in range(0, x.shape[0], chunk)], dim=0)
