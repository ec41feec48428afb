"""Synthetic vector corpora fitted to the paper's workload shapes (Table 2,
Fig. 1); a copy of the vector part of ``repro.data.synthetic``, so the same
seed gives the same corpus in both packages.

Vector corpora are Gaussian-mixture clustered (real embedding corpora are
strongly clustered — that is the premise of clustering-based ANNS); queries
are sampled near corpus modes with temperature, and per-query top-k follows
each service's production range (Fig. 1c).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VectorDatasetSpec:
    name: str
    n: int
    dim: int
    topk_lo: int
    topk_hi: int
    n_modes: int = 64
    spread: float = 0.25     # intra-cluster std relative to inter-mode std
    seed: int = 0


# Table 2, scaled to container-feasible sizes (scale factor recorded so the
# benchmarks can report the paper-relative setting).
PAPER_DATASETS = {
    "sift":    VectorDatasetSpec("sift",    100_000, 128, 10, 3000, seed=1),
    "redsrch": VectorDatasetSpec("redsrch", 200_000,  64, 100, 3000, seed=2),
    "redrec":  VectorDatasetSpec("redrec",  100_000,  64, 100, 1000, seed=3),
    "redads":  VectorDatasetSpec("redads",   50_000, 128, 100, 3000, seed=4),
    "redcm":   VectorDatasetSpec("redcm",   100_000,  64, 100,  500, seed=5),
    "redrag":  VectorDatasetSpec("redrag",   20_000, 1024, 10,  100, seed=6),
}


def make_vectors(spec: VectorDatasetSpec) -> np.ndarray:
    rng = np.random.default_rng(spec.seed)
    modes = rng.normal(size=(spec.n_modes, spec.dim)).astype(np.float32)
    weights = rng.dirichlet(np.full(spec.n_modes, 1.5))
    which = rng.choice(spec.n_modes, size=spec.n, p=weights)
    x = modes[which] + spec.spread * rng.normal(size=(spec.n, spec.dim))
    return x.astype(np.float32)


def make_queries(
    spec: VectorDatasetSpec, n_queries: int, temp: float = 1.2, seed: int = 100
) -> tuple[np.ndarray, np.ndarray]:
    """Queries near corpus modes + per-query top-k from the service range
    (log-uniform — production top-k is heavy at the low end)."""
    rng = np.random.default_rng(spec.seed + seed)
    modes = np.random.default_rng(spec.seed).normal(
        size=(spec.n_modes, spec.dim)
    ).astype(np.float32)
    which = rng.choice(spec.n_modes, size=n_queries)
    q = modes[which] + temp * spec.spread * rng.normal(size=(n_queries, spec.dim))
    lo, hi = np.log(spec.topk_lo), np.log(spec.topk_hi)
    topk = np.exp(rng.uniform(lo, hi, size=n_queries)).astype(np.int32)
    return q.astype(np.float32), np.clip(topk, spec.topk_lo, spec.topk_hi)
