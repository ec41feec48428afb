"""k-means for construction stage 1 (port of ``repro.build.kmeans``).

Every Lloyd iteration runs on the device without a host round trip: the
fused assign-and-accumulate kernel (K2) gives assignments, min distances,
per-centroid sums and counts; the worst-served points are picked with a
stable descending sort (lowest index first among ties, the order of the
reference's ``jax.lax.top_k``); the fused M-step kernel (K3) divides and
reseeds empty clusters.  On CPU tensors the same calls run the kernels'
plain versions (``kernels/ops.py``).

The reference's unfused A/B path (``fused=False``) distances through the
``pairwise_l2`` kernel, which a later slice ports; here it raises.
``balanced_hierarchical_kmeans`` is the SPANN-style recursive splitter that
bounds every leaf at ``max_cluster_size``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops


def kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0,
           fused: bool = True, *, device: DeviceLike = None
           ) -> tuple[np.ndarray, np.ndarray, float]:
    """Lloyd's algorithm. Returns (centroids (k, D), assign (N,), inertia)."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, _ = x.shape
    k = max(1, min(int(k), n))
    rng = np.random.default_rng(seed)
    cents = x[rng.choice(n, size=k, replace=False)].astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    cd = torch.from_numpy(np.ascontiguousarray(cents)).to(dev)
    if not fused:
        kops.kmeans_assign(xd, cd)                   # raises: pairwise_l2
    a = md = None
    for _ in range(max(1, iters)):
        a, md, sums, counts = kops.kmeans_assign_update(xd, cd)
        worst = torch.sort(md, descending=True, stable=True).indices[:k]
        cd = kops.kmeans_mstep(sums, counts, xd[worst])
    return (cd.cpu().numpy(), a.cpu().numpy().astype(np.int32),
            float(md.cpu().numpy().sum()))


def balanced_hierarchical_kmeans(
    x: np.ndarray,
    max_cluster_size: int,
    iters: int = 8,
    seed: int = 0,
    branch: int = 8,
    fused: bool = True,
    *,
    device: DeviceLike = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Recursive balanced clustering: split until every leaf fits the bound.

    Returns (centroids (C, D) f32 = leaf means, assign (N,) int32).  A
    degenerate split falls back to a median split along the highest-variance
    axis, so termination is guaranteed.
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    stack = [np.arange(n)]
    leaves: list[np.ndarray] = []
    task_seed = seed
    while stack:
        idxs = stack.pop()
        if idxs.size <= max_cluster_size:
            leaves.append(idxs)
            continue
        k = int(min(branch, max(2, -(-idxs.size // max_cluster_size))))
        task_seed += 1
        _, a, _ = kmeans(x[idxs], k, iters=iters, seed=task_seed, fused=fused,
                         device=dev)
        sizes = np.bincount(a, minlength=k)
        if (sizes == idxs.size).any():  # degenerate: force a median split
            dim = int(np.argmax(x[idxs].var(axis=0)))
            order = idxs[np.argsort(x[idxs][:, dim], kind="stable")]
            half = idxs.size // 2
            stack.append(order[:half])
            stack.append(order[half:])
            continue
        for j in range(k):
            sub = idxs[a == j]
            if sub.size:
                stack.append(sub)
    leaves.sort(key=lambda l: int(l[0]))  # deterministic leaf order
    cents = np.stack([x[l].mean(axis=0) for l in leaves]).astype(np.float32)
    assign = np.empty(n, np.int32)
    for ci, l in enumerate(leaves):
        assign[l] = ci
    return cents, assign


def enforce_size_bound(
    x: np.ndarray,
    centroids: np.ndarray,
    bound: int,
    max_rounds: int = 20,
    seed: int = 0,
    fused: bool = True,
    *,
    device: DeviceLike = None,
) -> np.ndarray:
    """Split Voronoi cells larger than ``bound`` until none remain.

    Each round reassigns all points with the fused kernel (its counts are
    the cell sizes) and 2-way-splits every oversized cell; a cell's points
    are taken in index order, as the reference's ``x[a == c]``.
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    cents = np.asarray(centroids, np.float32).copy()
    xd = torch.from_numpy(x).to(dev)
    for rnd in range(max_rounds):
        cd = torch.from_numpy(cents).to(dev)
        if not fused:
            kops.kmeans_assign(xd, cd)               # raises: pairwise_l2
        a, _, _, counts = kops.kmeans_assign_update(xd, cd)
        a = a.cpu().numpy()
        counts = counts.cpu().numpy().astype(np.int64)
        over = np.nonzero(counts > bound)[0]
        if over.size == 0:
            break
        order = np.argsort(a, kind="stable")          # index order per cell
        starts = np.concatenate([[0], np.cumsum(counts)])
        new_rows = []
        for c in over:
            pts = x[order[starts[c]:starts[c + 1]]]
            sub, _, _ = kmeans(pts, 2, iters=4, seed=seed + 131 * rnd + int(c),
                               fused=fused, device=dev)
            cents[c] = sub[0]
            if sub.shape[0] > 1:
                new_rows.append(sub[1])
        if new_rows:
            cents = np.concatenate([cents, np.stack(new_rows)], axis=0)
    return cents
