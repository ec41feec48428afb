"""k-means for construction stage 1 (port of ``repro.build.kmeans``).

Every Lloyd iteration runs on the device without a host round trip: the
fused assign-and-accumulate kernel (K2) gives assignments, min distances,
per-centroid sums and counts; the worst-served points are picked with a
stable descending sort (lowest index first among ties, the order of the
reference's ``jax.lax.top_k``); the fused M-step kernel (K3) divides and
reseeds empty clusters.  On CPU tensors the same calls run the kernels'
plain versions (``kernels/ops.py``).

The unfused A/B path (``fused=False``, ``BuildConfig(fused_assign=False)``)
is the reference's legacy loop: the E-step is ``ops.kmeans_assign`` (the
``pairwise_l2`` kernel B5 plus argmin on the device), the M-step a host
float64 scatter-add, the reseed a stable host argsort; centroids live on
the host between iterations.

``balanced_hierarchical_kmeans`` is the SPANN-style recursive splitter that
bounds every leaf at ``max_cluster_size``, one ``kmeans`` call per internal
node.  ``balanced_hierarchical_kmeans_many`` runs many such splitters (one
per chunk) in lockstep: each step pops every chunk's next node in that
chunk's own DFS order and runs all the popped nodes' Lloyd loops in one
``ops.kmeans_batched`` launch (K23), so it returns, chunk by chunk, exactly
what the per-node splitter returns.  ``enforce_size_bound``'s fused rounds
run their 2-means the same way, one K23 launch a round.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.kmeans_batched import MAX_K, lloyd


def kmeans_assign_step(xd: torch.Tensor, cents: np.ndarray,
                       x: np.ndarray):
    """One unfused Lloyd data pass: (assign (N,) int64, min_dist (N,) f32,
    sums (K, D) f64, counts (K,) int64).  ``xd`` is ``x`` on the device;
    the sums are a host float64 scatter-add in index order, as the
    reference's ``np.add.at``."""
    k, d = cents.shape
    a, md = kops.kmeans_assign(xd, torch.from_numpy(cents).to(xd.device))
    assign = a.cpu().numpy().astype(np.int64)
    sums = np.zeros((k, d), np.float64)
    np.add.at(sums, assign, x)
    counts = np.bincount(assign, minlength=k)
    return assign, md.cpu().numpy(), sums, counts


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
    if not fused:
        cents = cents.copy()
        assign = np.zeros(n, np.int64)
        mind = np.zeros(n, np.float32)
        for _ in range(max(1, iters)):
            assign, mind, sums, counts = kmeans_assign_step(xd, cents, x)
            nonz = counts > 0
            cents[nonz] = (sums[nonz] / counts[nonz, None]).astype(np.float32)
            if (~nonz).any():   # reseed empty clusters, worst-served first
                far = np.argsort(-mind, kind="stable")[: int((~nonz).sum())]
                cents[~nonz] = x[far]
        return cents, assign.astype(np.int32), float(mind.sum())
    cd = torch.from_numpy(np.ascontiguousarray(cents)).to(dev)
    cd, a, md, _ = lloyd(xd, cd, iters, kops.kmeans_assign_update,
                         kops.kmeans_mstep)
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
        k = _split_k(idxs.size, max_cluster_size, branch)
        task_seed += 1
        _, a, _ = kmeans(x[idxs], k, iters=iters, seed=task_seed, fused=fused,
                         device=dev)
        stack.extend(_children(x, idxs, a, k))
    return _leaf_means(x, leaves)


def _split_k(size: int, max_cluster_size: int, branch: int) -> int:
    return int(min(branch, max(2, -(-size // max_cluster_size))))


def _children(x: np.ndarray, idxs: np.ndarray, a: np.ndarray,
              k: int) -> list:
    """The nodes a split of ``idxs`` pushes, in push order: when k-means
    put every point in one cluster, a median split along the axis of
    highest variance (so the recursion ends); else each non-empty cluster's
    points, ``idxs[a == j]`` in index order, for j = 0 .. k-1."""
    sizes = np.bincount(a, minlength=k)
    if (sizes == idxs.size).any():
        xi = x[idxs]
        dim = int(np.argmax(xi.var(axis=0)))
        order = idxs[np.argsort(xi[:, dim], kind="stable")]
        half = idxs.size // 2
        return [order[:half], order[half:]]
    members = idxs[np.argsort(a, kind="stable")]
    ends = np.cumsum(sizes)
    return [members[e - m:e] for m, e in zip(sizes, ends) if m]


def _leaf_means(x: np.ndarray, leaves: list) -> tuple[np.ndarray, np.ndarray]:
    leaves.sort(key=lambda l: int(l[0]))  # deterministic leaf order
    cents = np.stack([x[l].mean(axis=0) for l in leaves]).astype(np.float32)
    assign = np.empty(x.shape[0], np.int32)
    for ci, l in enumerate(leaves):
        assign[l] = ci
    return cents, assign


def _lloyd_many(xd: torch.Tensor, groups: list, ks: list, seeds: list,
                iters: int, events=None):
    """``kmeans(x[g], k, iters, seed)`` (fused) for every (g, k, seed) in
    one ``ops.kmeans_batched`` launch (K23): sub-problem i is the rows
    ``groups[i]`` of ``xd`` in that order, started from the rows
    ``kmeans`` draws from ``seeds[i]``.  Returns K23's (assign, min_dist,
    cents (S, 16, D), counts)."""
    offs = np.zeros(len(groups) + 1, np.int32)
    offs[1:] = np.cumsum([g.size for g in groups])
    init = np.zeros((len(groups), MAX_K), np.int32)
    for r, (g, k, sd) in enumerate(zip(groups, ks, seeds)):
        rng = np.random.default_rng(sd)
        init[r, :k] = rng.choice(g.size, size=k, replace=False)
    return kops.kmeans_batched(
        xd, torch.from_numpy(np.concatenate(groups).astype(np.int32)),
        torch.from_numpy(offs), torch.from_numpy(np.asarray(ks, np.int32)),
        torch.from_numpy(init), iters, events=events)


@dataclasses.dataclass
class SplitStats:
    """What one lockstep run of ``balanced_hierarchical_kmeans_many`` did:
    its steps (one K23 launch each) and the sub-problems they held; host
    seconds spent on bookkeeping (popping nodes, splitting them) and in the
    K23 call (seed draws, index arrays and their checks, upload, launch,
    until the assignments are back on the host), and the whole call's
    seconds (with the corpus upload and the leaf means); on a card, K23's
    device ms per step (CUDA events around the launch)."""
    steps: int = 0
    subproblems: int = 0
    host_s: float = 0.0
    wait_s: float = 0.0
    wall_s: float = 0.0
    kernel_ms: list = dataclasses.field(default_factory=list)
    # host-clock stamps of the sums above: the thread that ran the call;
    # (start, loop start, loop end, end) of each call; (t0, t1, t2, t3,
    # sub-problems) of each step, K23 from t1 to t2 (the last, with none,
    # pops the leaves only)
    track: str = ""
    calls: list = dataclasses.field(default_factory=list)
    step_stamps: list = dataclasses.field(default_factory=list)

    def spans(self) -> list[tuple[str, float, float, str, Optional[dict]]]:
        """(name, t0, t1, track, args) trace spans of the calls, from the
        stamps (no extra clock reads): each call a ``stage1.split`` span,
        inside it the corpus's upload (``stage1.upload``), each step's
        ``stage1.k23`` (args: its sub-problems) between ``stage1.host``
        spans (popping the nodes, splitting them), then the leaves' means
        (``stage1.means``)."""
        out = []
        for c0, l0, l1, c1 in self.calls:
            out += [("stage1.split", c0, c1, self.track, None),
                    ("stage1.upload", c0, l0, self.track, None),
                    ("stage1.means", l1, c1, self.track, None)]
        for t0, t1, t2, t3, n in self.step_stamps:
            out.append(("stage1.host", t0, t1, self.track, None))
            if n:
                out += [("stage1.k23", t1, t2, self.track,
                         {"subproblems": n}),
                        ("stage1.host", t2, t3, self.track, None)]
        return [sp for sp in out if sp[2] > sp[1] > 0.0]


def balanced_hierarchical_kmeans_many(
    chunks: list,
    seeds: list,
    max_cluster_size: int,
    iters: int = 8,
    branch: int = 8,
    *,
    device: DeviceLike = None,
    stats: SplitStats | None = None,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """``balanced_hierarchical_kmeans(chunks[i], seed=seeds[i], ...)`` (fused)
    for every chunk, bit for bit, with one K23 launch per lockstep step.

    A node's seed is its chunk's seed plus the number of internal nodes the
    chunk popped up to it, so a chunk's nodes run one after another; the
    chunks are independent, so each step takes one node from every chunk
    that has one left.  ``stats``, when given, is filled in, with the
    stamps of its sums (:meth:`SplitStats.spans`)."""
    dev = resolve_device(device)
    xs = [np.asarray(c, np.float32) for c in chunks]
    if len(seeds) != len(xs):
        raise ValueError(f"{len(xs)} chunks but {len(seeds)} seeds")
    if not xs:
        return []
    st = stats if stats is not None else SplitStats()
    st.track = threading.current_thread().name
    t_call = time.perf_counter()
    base = np.cumsum([0] + [c.shape[0] for c in xs])
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    with ctx:
        xd = torch.from_numpy(np.concatenate(xs)).to(dev)
        stacks = [[np.arange(c.shape[0])] for c in xs]
        leaves: list[list] = [[] for _ in xs]
        task_seed = [int(s) for s in seeds]
        t_loop0 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            nodes = []                            # (chunk, idxs, k, seed)
            for i, stack in enumerate(stacks):
                while stack:
                    idxs = stack.pop()
                    if idxs.size <= max_cluster_size:
                        leaves[i].append(idxs)
                        continue
                    task_seed[i] += 1
                    nodes.append((i, idxs, _split_k(idxs.size,
                                                    max_cluster_size, branch),
                                  task_seed[i]))
                    break
            if not nodes:
                t_loop1 = time.perf_counter()
                st.host_s += t_loop1 - t0
                st.step_stamps.append((t0, t_loop1, t_loop1, t_loop1, 0))
                break
            events = None
            if stream is not None:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            t1 = time.perf_counter()
            a = _lloyd_many(xd, [base[i] + idxs for i, idxs, _, _ in nodes],
                            [k for _, _, k, _ in nodes],
                            [sd for _, _, _, sd in nodes], iters,
                            events=events)[0]
            a = a.cpu().numpy()
            t2 = time.perf_counter()
            if events is not None:
                st.kernel_ms.append(events[0].elapsed_time(events[1]))
            at = 0
            for i, idxs, k, _ in nodes:
                stacks[i].extend(_children(xs[i], idxs,
                                           a[at:at + idxs.size], k))
                at += idxs.size
            t3 = time.perf_counter()
            st.steps += 1
            st.subproblems += len(nodes)
            st.wait_s += t2 - t1
            st.host_s += (t1 - t0) + (t3 - t2)
            st.step_stamps.append((t0, t1, t2, t3, len(nodes)))
    out = [_leaf_means(x, lv) for x, lv in zip(xs, leaves)]
    t_end = time.perf_counter()
    st.wall_s += t_end - t_call
    st.calls.append((t_call, t_loop0, t_loop1, t_end))
    return out


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

    Each round reassigns all points (fused: the kernel's counts are the
    cell sizes; unfused: ``ops.kmeans_assign`` and a host bincount) and
    2-way-splits every oversized cell with ``kmeans(cell, 2, iters=4)``; a
    cell's points are taken in index order, as the reference's
    ``x[a == c]``.  Fused, a round's 2-means (independent, with fixed
    seeds) run together in one K23 launch.
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    cents = np.asarray(centroids, np.float32).copy()
    xd = torch.from_numpy(x).to(dev)
    for rnd in range(max_rounds):
        cd = torch.from_numpy(cents).to(dev)
        if fused:
            a, _, _, counts = kops.kmeans_assign_update(xd, cd)
            a = a.cpu().numpy()
            counts = counts.cpu().numpy().astype(np.int64)
        else:
            a, _ = kops.kmeans_assign(xd, cd)
            a = a.cpu().numpy()
            counts = np.bincount(a, minlength=cents.shape[0])
        over = np.nonzero(counts > bound)[0]
        if over.size == 0:
            break
        order = np.argsort(a, kind="stable")          # index order per cell
        starts = np.concatenate([[0], np.cumsum(counts)])
        cells = [order[starts[c]:starts[c + 1]] for c in over]
        seeds = [seed + 131 * rnd + int(c) for c in over]
        if fused:
            ks = [min(2, g.size) for g in cells]     # kmeans()'s clamp
            out = _lloyd_many(xd, cells, ks, seeds, 4)[2].cpu().numpy()
            subs = [out[i, :k] for i, k in enumerate(ks)]
        else:
            subs = [kmeans(x[g], 2, iters=4, seed=sd, fused=False,
                           device=dev)[0] for g, sd in zip(cells, seeds)]
        new_rows = []
        for c, sub in zip(over, subs):
            cents[c] = sub[0]
            if sub.shape[0] > 1:
                new_rows.append(sub[1])
        if new_rows:
            cents = np.concatenate([cents, np.stack(new_rows)], axis=0)
    return cents


# --------------------------------------------------------------------------
# one distributed Lloyd step (the stage-1 build cell of the reference's
# dry runs)
# --------------------------------------------------------------------------
ONE_HOT_ROWS = 65536        # rows a chunk of the unfused step's one-hot


def _one_hot_sums(x: torch.Tensor, cents: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's inline unfused pass: squared_l2, argmin, one-hot
    and the one-hot product, over chunks of ``ONE_HOT_ROWS`` rows so the
    (rows, K) tiles stay bounded.  Counts are f32, as the reference's."""
    from repro_torch.core.distance import squared_l2

    k = cents.shape[0]
    sums = torch.zeros_like(cents, dtype=torch.float32)
    counts = torch.zeros((k,), dtype=torch.float32, device=cents.device)
    for s in range(0, x.shape[0], ONE_HOT_ROWS):
        xs = x[s:s + ONE_HOT_ROWS]
        a = torch.argmin(squared_l2(xs, cents), dim=1)
        oh = torch.nn.functional.one_hot(a, k).to(torch.float32)
        sums += oh.T @ xs
        counts += torch.sum(oh, dim=0)
    return sums, counts


def kmeans_sharded_sums(mesh, x_local: torch.Tensor, cents: torch.Tensor,
                        fused: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-centroid (sums (K, D), counts (K,)) of every rank's rows: this
    rank's pass (K2 when ``fused``, else the inline one-hot), all-reduced
    over every mesh axis but ``model``."""
    from repro_torch.distributed.collectives import all_reduce

    if fused:
        _, _, sums, counts = kops.kmeans_assign_update(x_local, cents)
    else:
        sums, counts = _one_hot_sums(x_local, cents)
    for axis in (a for a in mesh.axis_names if a != "model"):
        sums = all_reduce(sums, mesh.group(axis))
        counts = all_reduce(counts, mesh.group(axis))
    return sums, counts


def kmeans_sharded_step(mesh, x_local: torch.Tensor, cents: torch.Tensor,
                        k: int, fused: bool = True) -> torch.Tensor:
    """One distributed Lloyd iteration: ``x_local`` is this rank's block of
    rows (split over the data axes), ``cents`` (K, D) replicated; every
    rank returns the same new centroids, ``where(counts > 0, sums /
    max(counts, 1), cents)`` (plain torch, as the reference's jnp M-step).
    ``k`` is the reference's unused argument.  Given DTensors (the global
    rows split over the data axes, the centroids replicated), it returns
    a replicated DTensor."""
    from repro_torch.distributed.sharding import P, local_region

    def step(x_local, cents):
        sums, counts = kmeans_sharded_sums(mesh, x_local, cents, fused)
        c = counts.to(torch.float32)[:, None]
        return torch.where(c > 0, sums / torch.clamp_min(c, 1.0), cents)

    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    return local_region(step, mesh, (P(data_axes), P()), (P(),))(
        x_local, cents)
