"""Leveling-Learned Search Pruning, LLSP (port of ``repro.core.llsp``).

Router GBDT: (query, top-k) -> level (a coarse max nprobe).  Per-level
pruning GBDT: (query, top-k, centroid-distance distribution) -> refined
nprobe.  Only pre-search features are used, so posting reads stay one
dependency-free batch.  Inference is torch on the serving device; training
is numpy on the CPU, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .gbdt import GBDTParams, GBDTRegressor, predict, predict_stacked, \
    stack_params


@dataclasses.dataclass(frozen=True)
class LLSPConfig:
    levels: tuple[int, ...] = (16, 32, 64, 128, 256)  # nprobe upper bounds
    recall_target: float = 0.9
    n_ratio_features: int = 32       # centroid-distance ratios fed to pruner
    label_nprobe: int = 0            # 0 => use max level for label generation
    n_trees: int = 80
    max_depth: int = 5
    lr: float = 0.2

    @property
    def nmax(self) -> int:
        return self.levels[-1]


@dataclasses.dataclass
class LLSPParams:
    router: GBDTParams
    pruners: GBDTParams              # stacked, leading dim = n_levels
    levels: torch.Tensor             # (n_levels,) int32

    def to(self, device) -> "LLSPParams":
        return LLSPParams(self.router.to(device), self.pruners.to(device),
                          self.levels.to(device))


# --------------------------------------------------------------------------
# feature builders (shared online/offline)
# --------------------------------------------------------------------------
def router_features(queries: torch.Tensor, topk: torch.Tensor
                    ) -> torch.Tensor:
    """(B, D) + (B,) -> (B, D+1)."""
    return torch.cat([queries,
                      torch.log1p(topk.to(torch.float32))[:, None]], dim=1)


def pruner_features(queries: torch.Tensor, topk: torch.Tensor,
                    cdists: torch.Tensor, n_ratio: int) -> torch.Tensor:
    """(B, D), (B,), (B, nmax sorted centroid dists) -> (B, D+2+n_ratio):
    query coords, log top-k, sqrt(d1), ratios d_i/d1 for i = 1..n_ratio."""
    d1 = torch.clamp_min(cdists[:, :1], 1e-12)
    ratios = cdists[:, 1:n_ratio + 1] / d1
    return torch.cat([queries,
                      torch.log1p(topk.to(torch.float32))[:, None],
                      torch.sqrt(d1), ratios], dim=1)


# --------------------------------------------------------------------------
# online inference
# --------------------------------------------------------------------------
def route(params: LLSPParams, queries: torch.Tensor, topk: torch.Tensor
          ) -> torch.Tensor:
    """Per-query level index (B,) int32."""
    n_levels = params.levels.shape[0]
    raw = predict(params.router, router_features(queries, topk))
    return torch.clamp(torch.round(raw), 0, n_levels - 1).to(torch.int32)


def prune(params: LLSPParams, level: torch.Tensor, queries: torch.Tensor,
          topk: torch.Tensor, cdists: torch.Tensor, n_ratio: int
          ) -> torch.Tensor:
    """Per-query nprobe (B,) int32 within [1, level_max]."""
    feats = pruner_features(queries, topk, cdists, n_ratio)
    raw = predict_stacked(params.pruners, level, feats)
    level_max = params.levels[level.long()].to(torch.float32)
    return torch.minimum(torch.clamp_min(torch.ceil(raw), 1.0),
                         level_max).to(torch.int32)


# --------------------------------------------------------------------------
# offline label generation + training (numpy)
# --------------------------------------------------------------------------
def min_nprobe_labels(
    centroid_rank_of_hit: np.ndarray,   # (B, kmax) rank of first cluster holding
    recall_target: float,               #        each true neighbor (nmax = miss)
    nmax: int,
    topk: np.ndarray | None = None,     # (B,) per-query k (pad cols = nmax rank)
) -> np.ndarray:
    """Closed-form minimal nprobe reaching target recall per query: 1 + the
    ceil(target*k)-th smallest first-hit rank."""
    b, kmax = centroid_rank_of_hit.shape
    if topk is None:
        topk = np.full(b, kmax)
    need = np.ceil(recall_target * np.asarray(topk)).astype(np.int64)
    need = np.clip(need, 1, kmax)
    ranks_sorted = np.sort(centroid_rank_of_hit, axis=1)
    min_np = ranks_sorted[np.arange(b), need - 1] + 1
    return np.clip(min_np, 1, nmax).astype(np.int32)


def first_hit_ranks(
    true_ids: np.ndarray,      # (B, k)
    cid_order: np.ndarray,     # (B, nmax) centroid ids sorted by distance
    posting_ids: np.ndarray,   # (C, L)
    n_vectors: int,
    nmax: int,
) -> np.ndarray:
    """Rank (position in the query's centroid ordering) of the first cluster
    containing each true neighbor; nmax if not reachable within nmax."""
    C, L = posting_ids.shape
    flat = posting_ids.ravel()
    valid = flat >= 0
    vec = flat[valid]
    clu = np.repeat(np.arange(C, dtype=np.int64), L)[valid]
    order = np.argsort(vec, kind="stable")
    vec_s, clu_s = vec[order], clu[order]
    starts = np.searchsorted(vec_s, np.arange(n_vectors))
    ends = np.searchsorted(vec_s, np.arange(n_vectors) + 1)

    B, k = true_ids.shape
    out = np.full((B, k), nmax, dtype=np.int32)
    for b in range(B):
        rank_of = {int(c): r for r, c in enumerate(cid_order[b])}
        for j in range(k):
            v = int(true_ids[b, j])
            if v < 0:
                continue
            best = nmax
            for c in clu_s[starts[v]:ends[v]]:
                r = rank_of.get(int(c), nmax)
                if r < best:
                    best = r
            out[b, j] = best
    return out


def train_llsp(
    cfg: LLSPConfig,
    queries: np.ndarray,        # (B, D) training queries (sampled log window)
    topk: np.ndarray,           # (B,) business top-k per query
    cid_order: np.ndarray,      # (B, nmax) centroid ids by distance
    cdists: np.ndarray,         # (B, nmax) sorted centroid distances
    true_ids: np.ndarray,       # (B, k) approx ground truth (large-nprobe run)
    posting_ids: np.ndarray,    # (C, L)
    n_vectors: int,
    seed: int = 0,
) -> LLSPParams:
    """Offline LLSP training; returns CPU params (move with ``.to``)."""
    levels = np.asarray(cfg.levels, dtype=np.int32)
    nmax = int(levels[-1])
    ranks = first_hit_ranks(true_ids, cid_order, posting_ids, n_vectors, nmax)
    ranks = np.where(true_ids < 0, nmax, ranks)
    min_np = min_nprobe_labels(ranks, cfg.recall_target, nmax, topk=topk)

    lvl_label = np.searchsorted(levels, min_np, side="left")
    lvl_label = np.clip(lvl_label, 0, len(levels) - 1)
    q = torch.from_numpy(np.asarray(queries, np.float32))
    tk = torch.from_numpy(np.asarray(topk))
    rf = router_features(q, tk).numpy()
    router = GBDTRegressor(
        n_trees=cfg.n_trees, max_depth=cfg.max_depth, lr=cfg.lr, seed=seed
    ).fit(rf, lvl_label.astype(np.float64))

    pf = pruner_features(q, tk, torch.from_numpy(np.asarray(cdists)),
                         cfg.n_ratio_features).numpy()
    pruners = []
    for li in range(len(levels)):
        sel = lvl_label == li
        if sel.sum() < 32:  # too few samples: fall back to all data clipped
            Xl, yl = pf, np.minimum(min_np, levels[li]).astype(np.float64)
        else:
            Xl, yl = pf[sel], min_np[sel].astype(np.float64)
        m = GBDTRegressor(
            n_trees=cfg.n_trees, max_depth=cfg.max_depth, lr=cfg.lr,
            seed=seed + 101 * li,
        ).fit(Xl, yl)
        pruners.append(m.params)
    return LLSPParams(router=router.params, pruners=stack_params(pruners),
                      levels=torch.from_numpy(levels))
