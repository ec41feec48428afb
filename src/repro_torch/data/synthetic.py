"""Synthetic data generators fitted to the paper's workload shapes (Table 2,
Fig. 1) plus token/graph/recsys feeds for the assigned architectures; a
copy of ``repro.data.synthetic``, so the same seed gives the same arrays in
both packages.

Vector corpora are Gaussian-mixture clustered (real embedding corpora are
strongly clustered — that is the premise of clustering-based ANNS); queries
are sampled near corpus modes with temperature, and per-query top-k follows
each service's production range (Fig. 1c).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


# ---------------------------------------------------------------------------
# model-zoo feeds
# ---------------------------------------------------------------------------
def token_batch(batch: int, seq: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    return tokens


def random_graph(n_nodes: int, n_edges: int, d_feat: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    return src, dst, feats


def neighbor_sample(
    src: np.ndarray,
    dst: np.ndarray,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: Optional[np.random.Generator] = None,
):
    """Layered neighbor sampler (GraphSAGE-style) for ``minibatch_lg``.

    Returns per-layer (edge_src, edge_dst) index arrays into the global node
    id space, plus the final frontier.  CSR built once, sampled per batch.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    order = np.argsort(dst, kind="stable")
    s_sorted, d_sorted = src[order], dst[order]
    n_nodes = int(max(src.max(initial=0), dst.max(initial=0))) + 1
    starts = np.searchsorted(d_sorted, np.arange(n_nodes))
    ends = np.searchsorted(d_sorted, np.arange(n_nodes) + 1)

    frontier = np.unique(seeds)
    layers = []
    for f in fanouts:
        es, ed = [], []
        for v in frontier:
            nbrs = s_sorted[starts[v]:ends[v]]
            if nbrs.size == 0:
                continue
            take = nbrs if nbrs.size <= f else rng.choice(nbrs, size=f, replace=False)
            es.append(take)
            ed.append(np.full(take.size, v, dtype=np.int32))
        if es:
            es = np.concatenate(es).astype(np.int32)
            ed = np.concatenate(ed).astype(np.int32)
        else:
            es = np.zeros(0, np.int32)
            ed = np.zeros(0, np.int32)
        layers.append((es, ed))
        frontier = np.unique(np.concatenate([frontier, es]))
    return layers, frontier


def recsys_batch(
    batch: int,
    n_sparse: int,
    table_rows: int,
    seq_len: int = 0,
    seed: int = 0,
):
    """Zipf-distributed sparse ids (production id popularity is zipfian) +
    optional behaviour sequence for DIN/MIND."""
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, size=(batch, n_sparse)) - 1) % table_rows
    out = {"sparse_ids": ids.astype(np.int32),
           "labels": rng.integers(0, 2, size=(batch,)).astype(np.float32)}
    if seq_len:
        seq = (rng.zipf(1.3, size=(batch, seq_len)) - 1) % table_rows
        length = rng.integers(1, seq_len + 1, size=(batch,))
        out["hist_ids"] = seq.astype(np.int32)
        out["hist_len"] = length.astype(np.int32)
    return out
