"""Graph-based ANNS baseline (the HNSW / DiskANN family of §2.2).

The paper's argument is comparative: greedy best-first graph traversal issues
*serialized, dependency-chained* reads, so on SSDs it cannot use the array's
bandwidth, while clustering-based search issues one dependency-free batch.
To reproduce Figs 4/14/15/16 we need the baseline itself:

* ``build_nsw_graph``   — kNN graph + RNG-rule edge pruning (the Vamana/NSW
  construction both HNSW and DiskANN derive from), degree-bounded.
* ``beam_search``       — best-first search with a beam ("ef"/"L"), counting
  HOPS (= serialized read rounds) and DISTANCE EVALS.  The hop count is what
  the DRAM-SSD latency model multiplies by the per-read latency; the eval
  count is the in-DRAM compute cost.

Implemented in numpy (the traversal is pointer-chasing, exactly the part the
paper shows does NOT vectorize onto wide hardware — that observation IS the
result).  This is the port of ``repro.core.graph_baseline``: only the exact
kNN candidate pass runs on a device (the port's ``squared_l2``, one chunk of
rows against the corpus at a time, each chunk brought back to numpy).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

import torch

from repro_torch.device import DeviceLike, resolve_device

from .distance import squared_l2


@dataclasses.dataclass
class NSWGraph:
    vectors: np.ndarray      # (N, D)
    neighbors: np.ndarray    # (N, R) int32, -1 padded
    entry: int

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]


def build_nsw_graph(x: np.ndarray, degree: int = 24, chunk: int = 2048,
                    rng_prune: bool = True, alpha: float = 1.2,
                    seed: int = 0, *, device: DeviceLike = None) -> NSWGraph:
    """kNN graph (exact, chunked) + alpha-relaxed RNG pruning (Vamana-style)
    + NSW random long links for navigability, degree-bounded.

    The strict RNG rule on a strongly clustered corpus prunes the graph into
    per-cluster islands (no long edges in a nearest-neighbor candidate pool),
    so like Vamana we relax occlusion by ``alpha`` and like NSW we reserve a
    few slots per node for random long-range links — both are what the real
    HNSW/DiskANN constructions do to stay navigable.  ``device`` runs the
    kNN pass (default: the card)."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    n_rand = max(2, degree // 6)
    n_near = degree - n_rand
    cand_k = min(degree * 2 + 1, n)
    nbrs = np.full((n, cand_k - 1), -1, dtype=np.int32)
    xj = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        resolve_device(device))
    a2 = alpha * alpha                   # squared-L2 domain
    for s in range(0, n, chunk):
        d = squared_l2(xj[s:s + chunk], xj).cpu().numpy()
        part = np.argpartition(d, cand_k - 1, axis=1)[:, :cand_k]
        # order candidates by distance, drop self
        for i in range(part.shape[0]):
            row = part[i]
            row = row[np.argsort(d[i, row])]
            row = row[row != s + i][:cand_k - 1]
            nbrs[s + i, :len(row)] = row
    out = np.full((n, degree), -1, dtype=np.int32)
    for i in range(n):
        if rng_prune:
            kept: list[int] = []
            for c in nbrs[i]:
                if c < 0 or len(kept) == n_near:
                    break
                dc = float(((x[i] - x[c]) ** 2).sum())
                ok = True
                for m in kept:
                    if a2 * float(((x[m] - x[c]) ** 2).sum()) < dc:
                        ok = False
                        break
                if ok:
                    kept.append(int(c))
        else:
            kept = [int(c) for c in nbrs[i, :n_near] if c >= 0]
        # NSW long links: random distinct nodes (connectivity/expander edges)
        extra = rng.choice(n, size=n_rand, replace=False)
        for e in extra:
            if e != i and e not in kept and len(kept) < degree:
                kept.append(int(e))
        out[i, :len(kept)] = kept
    # entry point: medoid-ish (closest to the mean)
    entry = int(np.argmin(((x - x.mean(0)) ** 2).sum(1)))
    return NSWGraph(vectors=np.ascontiguousarray(x), neighbors=out, entry=entry)


@dataclasses.dataclass
class SearchStats:
    hops: int                # serialized read rounds (I/O chain length)
    evals: int               # distance computations
    beam_reads: int          # node fetches (beam-batched I/O count)


def beam_search(g: NSWGraph, q: np.ndarray, k: int, beam: int,
                max_hops: int = 10_000) -> tuple[np.ndarray, SearchStats]:
    """Best-first beam search (DiskANN-style).  Returns (ids (k,), stats)."""
    x = g.vectors
    visited = {g.entry}
    d0 = float(((x[g.entry] - q) ** 2).sum())
    # candidate heap (min by dist), result heap (max by dist)
    cand = [(d0, g.entry)]
    results = [(-d0, g.entry)]
    hops = evals = reads = 0
    while cand and hops < max_hops:
        d, u = heapq.heappop(cand)
        worst = -results[0][0]
        if d > worst and len(results) >= beam:
            break
        hops += 1
        reads += 1
        nb = g.neighbors[u]
        nb = nb[nb >= 0]
        fresh = [v for v in nb.tolist() if v not in visited]
        visited.update(fresh)
        if fresh:
            dv = ((x[fresh] - q) ** 2).sum(1)
            evals += len(fresh)
            for v, dvv in zip(fresh, dv.tolist()):
                if len(results) < beam or dvv < -results[0][0]:
                    heapq.heappush(cand, (dvv, v))
                    heapq.heappush(results, (-dvv, v))
                    if len(results) > beam:
                        heapq.heappop(results)
    top = sorted(((-nd, v) for nd, v in results))[:k]
    ids = np.asarray([v for _, v in top], dtype=np.int32)
    if len(ids) < k:
        ids = np.pad(ids, (0, k - len(ids)), constant_values=-1)
    return ids, SearchStats(hops=hops, evals=evals, beam_reads=reads)


def batch_search(g: NSWGraph, queries: np.ndarray, k: int, beam: int):
    """Convenience loop; returns (ids (B,k), mean stats)."""
    ids = np.empty((queries.shape[0], k), dtype=np.int32)
    hops = evals = reads = 0
    for i, q in enumerate(queries):
        ids[i], st = beam_search(g, q, k, beam)
        hops += st.hops
        evals += st.evals
        reads += st.beam_reads
    b = queries.shape[0]
    return ids, SearchStats(hops // b, evals // b, reads // b)
