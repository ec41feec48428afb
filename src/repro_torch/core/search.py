"""Helmsman online search pieces (port of the plan-stage parts of
``repro.core.search``): the search config, the one-level centroid scan and
the per-query nprobe decision.  The resident ``serve_step`` /
``serve_leveled`` paths and the sharded engines come in later slices."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import llsp as llsp_mod
from .distance import squared_l2, topk_smallest
from .ivf import IVFIndex
from .spann_rules import fixed_eps_nprobe


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    k: int = 10
    nprobe_max: int = 64          # == LLSP nmax when pruning == "llsp"
    pruning: str = "none"         # "llsp" | "fixed" | "none"
    eps: float = 0.12             # fixed-eps baseline knob (Eq. 1)
    n_ratio: int = 32
    use_kernel: bool = True       # fused scan kernel (False: the packed-
                                  # domain oracle, an explicit A/B arm)
    n_cand: int = 0               # candidates per query the scan keeps
                                  # (0 = auto: ~2k rounded up to 8)


def _auto_ncand(k: int) -> int:
    """Default candidate width: ~2k, padded to a multiple of 8."""
    return -(-max(2 * k, 16) // 8) * 8


def centroid_scan(index: IVFIndex, queries: torch.Tensor, nmax: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-nmax centroids: (cdists (B, nmax) ascending, cids (B, nmax))."""
    return topk_smallest(squared_l2(queries, index.centroids), nmax)


def decide_nprobe(cfg: SearchConfig,
                  llsp_params: Optional[llsp_mod.LLSPParams],
                  queries: torch.Tensor, topk_req: torch.Tensor,
                  cdists: torch.Tensor) -> torch.Tensor:
    """Per-query nprobe (B,) int32 according to the pruning mode."""
    b = queries.shape[0]
    nmax = cdists.shape[1]
    if cfg.pruning == "none":
        return torch.full((b,), nmax, dtype=torch.int32,
                          device=queries.device)
    if cfg.pruning == "fixed":
        return fixed_eps_nprobe(cdists, cfg.eps, nmax)
    if cfg.pruning != "llsp" or llsp_params is None:
        raise ValueError(f"pruning={cfg.pruning!r} needs LLSP params")
    level = llsp_mod.route(llsp_params, queries, topk_req)
    return llsp_mod.prune(llsp_params, level, queries, topk_req, cdists,
                          cfg.n_ratio)
