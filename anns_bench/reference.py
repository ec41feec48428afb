"""The plain reference of the benchmark: plain torch, written from the
semantics the configurations state, importing nothing of the program.

Serving ("top-k by exact L2 over the probed clusters"):

* :func:`plan`: the nearest ``nprobe_max`` centroids of each query by
  squared L2 in float32, then LLSP's decision on them: the router ensemble
  picks a level, the level's pruning ensemble a count of probes, capped by
  the level's bound.  The ensembles are the trained trees the deployment
  serves with, handed over as plain arrays; the reference descends them
  itself.
* :func:`exact_topk`: the k nearest distinct ids, by exact L2 in float32
  from the corpus rows themselves, among the ids the first ``nprobe``
  clusters of the plan hold (f32 resident tier).
* :func:`q8_rerank_topk`: the int8 tier: each cluster's residuals to its
  centroid quantised symmetrically with one scale a cluster (the largest
  live residual over 127), the ``k2`` distinct ids nearest by the
  closed-form distance to those codes, then the k nearest of them by exact
  L2 from the corpus rows.

Build:

* :func:`closure` assigns every vector to its nearest centroid and to up
  to ``max_replicas - 1`` more within ``(1 + eps)`` of it that no kept
  centroid occludes (the RNG rule: c_j is dropped when a kept c_m is
  nearer to c_j than the vector is);
* :func:`posting_ids` lays the assignment out as fixed-size posting lists:
  a cluster's members column by column of the assignment, in id order
  within a column, the first ``cluster_len`` kept, -1 padding;
* :func:`distortion`: the corpus's mean squared distance to its nearest
  centroid;
* :func:`nprobe_labels`: the fewest probes, in each query's centroid
  order, that hold a target share of its exact top-k over ``nprobe_max``
  probes: what LLSP is trained to predict.

Every function takes ``precision``: "f32" computes the matrix products in
float32, "tf32" rounds their inputs to TF32's 10-bit mantissa first, which
is what a TF32 tensor-core product does; ``bits`` (8 or 4) sets the width
of the residual codes.  The lower settings are the controls the comparison
must reject.  :func:`f32_products` turns TF32 off for the process; the
harness calls it before the reference runs, so what the program sets does
not lower the reference's precision.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

INF = float("inf")


def f32_products() -> None:
    """Make float32 matrix products full float32 (TF32 off for cuBLAS and
    cuDNN), and raise if the setting does not hold."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("TF32 is still on: the reference's float32 "
                           "products would be TF32 products")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to 10 mantissa bits, half to even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = (b + 0xFFF + lsb) & ~0x1FFF
    return r.view(torch.float32)


def _mm_in(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision == "tf32":
        return tf32_round(x)
    raise ValueError(f"precision {precision!r}")


def sq_dists(a: torch.Tensor, b: torch.Tensor, precision: str = "f32"
             ) -> torch.Tensor:
    """(n, m) squared L2 by the expanded form, clamped at 0."""
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1)[None, :]
    ab = _mm_in(a, precision) @ _mm_in(b, precision).T
    return torch.clamp_min(a2 - 2.0 * ab + b2, 0.0)


# ---------------------------------------------------------------- LLSP trees
def _descend(feature, threshold, value, x):
    """Sum of the leaf values of the trees ``(T, nodes)`` for rows ``x``:
    node i has children 2i+1 (feature <= threshold) and 2i+2; a negative
    feature marks a leaf."""
    b = x.shape[0]
    t, n_nodes = feature.shape[-2:]
    depth = int(round(math.log2(n_nodes + 1))) - 1
    node = torch.zeros((b, t), dtype=torch.int64, device=x.device)
    tree = torch.arange(t, device=x.device)[None, :].expand(b, t)
    for _ in range(depth):
        f = feature[tree, node]
        fv = torch.gather(x, 1, torch.clamp_min(f, 0).long())
        nxt = torch.where(fv <= threshold[tree, node], 2 * node + 1,
                          2 * node + 2)
        node = torch.where(f < 0, node, nxt)
    return value[tree, node].sum(1)


def llsp_nprobe(trees: dict, queries: torch.Tensor, topk: torch.Tensor,
                cdists: torch.Tensor, n_ratio: int) -> torch.Tensor:
    """LLSP's probe count for each query from its sorted centroid distances.

    ``trees`` holds "router" and "pruners" (each a dict of ``feature``,
    ``threshold``, ``value``, ``base``, ``lr``; the pruners stacked by
    level) and "levels"."""
    r, p = trees["router"], trees["pruners"]
    levels = trees["levels"].to(torch.int64)
    ltk = torch.log1p(topk.to(torch.float32))[:, None]
    raw = r["base"] + r["lr"] * _descend(
        r["feature"], r["threshold"], r["value"],
        torch.cat([queries, ltk], 1))
    level = torch.clamp(torch.round(raw), 0, levels.numel() - 1).long()
    d1 = torch.clamp_min(cdists[:, :1], 1e-12)
    if cdists.shape[1] < n_ratio + 1:          # fewer centroids: +inf pads
        cdists = torch.cat([cdists, cdists.new_full(
            (cdists.shape[0], n_ratio + 1 - cdists.shape[1]), INF)], 1)
    feats = torch.cat([queries, ltk, torch.sqrt(d1),
                       cdists[:, 1:n_ratio + 1] / d1], 1)
    out = torch.empty(queries.shape[0], dtype=torch.int64,
                      device=queries.device)
    for li in range(levels.numel()):
        rows = (level == li).nonzero().flatten()
        if rows.numel() == 0:
            continue
        pr = p["base"][li] + p["lr"][li] * _descend(
            p["feature"][li], p["threshold"][li], p["value"][li],
            feats[rows])
        n = torch.clamp_min(torch.ceil(pr), 1.0)
        out[rows] = torch.minimum(n, levels[li].to(n.dtype)).long()
    return out


def plan(queries: torch.Tensor, centroids: torch.Tensor, trees: dict, *,
         nprobe_max: int, n_ratio: int, topk: int,
         precision: str = "f32", block: int = 1024):
    """(cids (B, nprobe_max) nearest first, nprobe (B,)) of ``queries``."""
    cids, nps = [], []
    for s in range(0, queries.shape[0], block):
        q = queries[s:s + block]
        d = sq_dists(q, centroids, precision)
        cd, ci = torch.topk(d, min(nprobe_max, d.shape[1]), dim=1,
                            largest=False, sorted=True)
        tk = torch.full((q.shape[0],), topk, device=q.device)
        nps.append(llsp_nprobe(trees, q, tk, cd, n_ratio))
        cids.append(ci)
    return torch.cat(cids), torch.cat(nps)


# ------------------------------------------------------------- scans
def _probed_ids(posting_ids: torch.Tensor, cids: torch.Tensor,
                nprobe: torch.Tensor) -> torch.Tensor:
    """(b, P * L) ids of each query's first nprobe clusters, every id once
    (repeats and padding -1)."""
    b, p = cids.shape
    live = torch.arange(p, device=cids.device)[None, :] < nprobe[:, None]
    ids = posting_ids[cids.long()]                          # (b, P, L)
    ids = torch.where(live[:, :, None], ids, -1).reshape(b, -1).long()
    srt, _ = torch.sort(ids, dim=1)
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    return torch.where(dup, -1, srt)


def _exact(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
           precision: str) -> torch.Tensor:
    """Exact squared L2 of each query to the rows ``ids`` (b, n) of ``x``;
    +inf where the id is -1.  "f32" sums the squared differences; "tf32"
    uses the expanded form with TF32 inputs, as a tensor-core scan would."""
    rows = x[torch.clamp_min(ids, 0)]                       # (b, n, D)
    if precision == "f32":
        d = ((rows - q[:, None, :]) ** 2).sum(-1)
    else:
        dot = torch.einsum("bnd,bd->bn", _mm_in(rows, precision),
                           _mm_in(q, precision))
        d = torch.clamp_min((q * q).sum(1)[:, None] - 2.0 * dot
                            + (rows * rows).sum(-1), 0.0)
    return torch.where(ids >= 0, d, INF)


def _trim(cids, nprobe):
    """The plan's columns up to the block's largest probe count."""
    return cids[:, :max(1, int(nprobe.max()))]


def exact_topk(queries, x, posting_ids, cids, nprobe, k: int, *,
               precision: str = "f32", budget: int = 1 << 28) -> torch.Tensor:
    """(B, k) ids: the k nearest distinct ids among the probed clusters."""
    l, dim = posting_ids.shape[1], x.shape[1]
    step = max(1, budget // (int(nprobe.max()) * l * dim))
    out = []
    for s in range(0, queries.shape[0], step):
        nps = nprobe[s:s + step]
        ids = _probed_ids(posting_ids, _trim(cids[s:s + step], nps), nps)
        d = _exact(queries[s:s + step], x, ids, precision)
        _, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
        out.append(torch.gather(ids, 1, pos))
    return torch.cat(out)


def quantize(x, centroids, posting_ids, bits: int = 8):
    """Residual codes of every posting slot: (codes (C, L, D) float32
    holding integers, scale (C,), norm2 (C, L) = scale^2 ||codes||^2).
    Dead slots get zero codes and take no part in the scale."""
    top = (1 << (bits - 1)) - 1
    live = posting_ids >= 0
    r = x[torch.clamp_min(posting_ids, 0).long()] - centroids[:, None, :]
    r = torch.where(live[:, :, None], r, 0.0)
    scale = torch.clamp_min(r.abs().amax(dim=(1, 2)) / top, 1e-12)
    codes = torch.clamp(torch.round(r / scale[:, None, None]), -top, top)
    return codes, scale, scale[:, None] ** 2 * (codes * codes).sum(-1)


def q8_rerank_topk(queries, x, centroids, posting_ids, quant, cids, nprobe,
                   k: int, k2: int, *, tie: float = 1e-5,
                   budget: int = 1 << 27):
    """((B, k) ids, (B,) tie) of the tiered path: the k2 distinct ids
    nearest by the residual-code distance (``quant`` from
    :func:`quantize`), then the k nearest of those by exact L2.  ``tie``
    marks the queries whose k2-th and (k2+1)-th code distances lie within
    a relative ``tie`` of each other: their candidate set is not decided
    by the rule alone, as float32 rounding may take either id."""
    codes, scale, norm2 = quant
    l, dim = posting_ids.shape[1], x.shape[1]
    step = max(1, budget // (int(nprobe.max()) * l * dim))
    out, ties = [], []
    for s in range(0, queries.shape[0], step):
        nps = nprobe[s:s + step]
        c = _trim(cids[s:s + step], nps).long()
        q = queries[s:s + step]
        b, p = c.shape
        live = torch.arange(p, device=q.device)[None, :] < nps[:, None]
        qc = q[:, None, :] - centroids[c]                     # (b, P, D)
        sc = scale[c][:, :, None]
        d = ((qc * qc).sum(-1)[:, :, None]
             - 2.0 * sc * torch.einsum("bpd,bpld->bpl", qc, codes[c])
             + norm2[c])
        d = torch.clamp_min(d, 0.0)
        ids = posting_ids[c].long()
        ok = live[:, :, None] & (ids >= 0)
        d = torch.where(ok, d, INF).reshape(b, -1)
        ids = torch.where(ok, ids, -1).reshape(b, -1)
        # per-id minimum, then the k2 nearest distinct ids
        order = torch.argsort(d, dim=1, stable=True)
        d, ids = torch.gather(d, 1, order), torch.gather(ids, 1, order)
        key, pos = torch.sort(ids, dim=1, stable=True)
        first = torch.ones_like(key, dtype=torch.bool)
        first[:, 1:] = key[:, 1:] != key[:, :-1]
        keep = torch.zeros_like(first).scatter_(1, pos, first)
        d = torch.where(keep & (ids >= 0), d, INF)
        cd, cp = torch.topk(d, k2 + 1, dim=1, largest=False, sorted=True)
        ties.append((cd[:, k2] - cd[:, k2 - 1]) <= tie * cd[:, k2])
        cd, cp = cd[:, :k2], cp[:, :k2]
        cand = torch.where(torch.isfinite(cd), torch.gather(ids, 1, cp), -1)
        e = _exact(q, x, cand, "f32")
        _, sel = torch.topk(e, k, dim=1, largest=False, sorted=True)
        out.append(torch.gather(cand, 1, sel))
    return torch.cat(out), torch.cat(ties)


# ------------------------------------------------------------- build
def closure(x, centroids, *, eps: float, max_replicas: int,
            precision: str = "f32", block: int = 1 << 16) -> torch.Tensor:
    """(N, max_replicas) int64 closure assignment, nearest first, -1 pad."""
    out = []
    for s in range(0, x.shape[0], block):
        xb = x[s:s + block]
        d = sq_dists(xb, centroids, precision)
        cd, cand = torch.topk(d, max_replicas, dim=1, largest=False,
                              sorted=True)
        window = cd <= (1.0 + eps) ** 2 * cd[:, :1]
        cc = centroids[cand]                                  # (n, R, D)
        ccd = ((cc[:, :, None, :] - cc[:, None, :, :]) ** 2).sum(-1)
        keep = torch.zeros_like(window)
        keep[:, 0] = True
        for j in range(1, max_replicas):
            occl = (keep & (ccd[:, :, j] < cd[:, j:j + 1])).any(1)
            keep[:, j] = window[:, j] & ~occl
        out.append(torch.where(keep, cand, -1))
    return torch.cat(out)


def posting_ids(assign: torch.Tensor, n_clusters: int, cluster_len: int
                ) -> torch.Tensor:
    """(C, L) posting ids of ``assign`` (N, R): members column by column,
    in id order within a column, the first ``cluster_len`` kept."""
    n, r = assign.shape
    col = torch.arange(r, device=assign.device).repeat(n)
    vid = torch.arange(n, device=assign.device).repeat_interleave(r)
    cl = assign.reshape(-1)
    m = cl >= 0
    col, vid, cl = col[m], vid[m], cl[m]
    key = (cl * r + col) * n + vid          # cluster, then column, then id
    order = torch.argsort(key)
    cl, vid = cl[order], vid[order]
    start = torch.searchsorted(cl, torch.arange(n_clusters,
                                                device=cl.device))
    rank = torch.arange(cl.numel(), device=cl.device) - start[cl]
    out = torch.full((n_clusters, cluster_len), -1, dtype=torch.int64,
                     device=assign.device)
    fit = rank < cluster_len
    out[cl[fit], rank[fit]] = vid[fit]
    return out


def membership(pids: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """(n, width) sorted cluster ids holding each vector, -1 padded (a
    vector held more than ``width`` times keeps its first ``width``)."""
    c, l = pids.shape
    cl = torch.arange(c, device=pids.device).repeat_interleave(l)
    v = pids.reshape(-1).long()
    m = v >= 0
    cl, v = cl[m], v[m]
    order = torch.argsort(v * c + cl)
    v, cl = v[order], cl[order]
    start = torch.searchsorted(v, torch.arange(n, device=v.device))
    rank = torch.arange(v.numel(), device=v.device) - start[v]
    out = torch.full((n, width), -1, dtype=torch.int64, device=pids.device)
    fit = rank < width
    out[v[fit], rank[fit]] = cl[fit]
    return out


def primary_counts(x, centroids, block: int = 1 << 16) -> torch.Tensor:
    """(C,) vectors whose nearest centroid each cluster is."""
    counts = torch.zeros(centroids.shape[0], dtype=torch.int64,
                         device=x.device)
    for s in range(0, x.shape[0], block):
        a = sq_dists(x[s:s + block], centroids).argmin(1)
        counts += torch.bincount(a, minlength=centroids.shape[0])
    return counts


def distortion(x, centroids, block: int = 1 << 16) -> float:
    """Mean over the rows of ``x`` of the squared L2 to the nearest
    centroid (summed in float64)."""
    total = 0.0
    for s in range(0, x.shape[0], block):
        total += float(sq_dists(x[s:s + block], centroids).amin(1)
                       .double().sum())
    return total / x.shape[0]


def nprobe_labels(queries, x, centroids, posting_ids, *, nprobe_max: int,
                  k: int, target: float) -> torch.Tensor:
    """(B,) the fewest probes n, in each query's centroid order, whose
    first n clusters hold ceil(target * k) of its exact top-k over
    ``nprobe_max`` probes (``nprobe_max`` where they never do)."""
    cids = torch.topk(sq_dists(queries, centroids),
                      min(nprobe_max, centroids.shape[0]), dim=1,
                      largest=False, sorted=True).indices
    full = torch.full((queries.shape[0],), cids.shape[1],
                      device=queries.device)
    true = exact_topk(queries, x, posting_ids, cids, full, k)   # (B, k)
    # rank of the first probed cluster that holds each true neighbour
    held = posting_ids[cids.long()]                             # (B, P, L)
    hit = (held[:, :, :, None] == true[:, None, None, :]).any(2)  # (B, P, k)
    pos = torch.arange(cids.shape[1], device=queries.device)
    rank = torch.where(hit, pos[None, :, None], cids.shape[1]).amin(1)
    rank = torch.where(true >= 0, rank, cids.shape[1])
    need = max(1, min(k, math.ceil(target * k)))
    nth = torch.sort(rank, dim=1).values[:, need - 1]
    return torch.clamp(nth + 1, 1, nprobe_max)


def exact_knn(queries, x, k: int, *, block_q: int = 4096,
              block_x: int = 1 << 18) -> torch.Tensor:
    """(B, k) ids of the exact k nearest corpus rows of each query."""
    out = []
    for s in range(0, queries.shape[0], block_q):
        q = queries[s:s + block_q]
        best_d: Optional[torch.Tensor] = None
        best_i: Optional[torch.Tensor] = None
        for t in range(0, x.shape[0], block_x):
            d = sq_dists(q, x[t:t + block_x])
            vd, vi = torch.topk(d, k, dim=1, largest=False)
            vi = vi + t
            if best_d is not None:
                vd, pos = torch.topk(torch.cat([best_d, vd], 1), k, dim=1,
                                     largest=False, sorted=True)
                vi = torch.gather(torch.cat([best_i, vi], 1), 1, pos)
            best_d, best_i = vd, vi
        out.append(best_i)
    return torch.cat(out)
