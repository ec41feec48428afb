"""The posting layout of a closure assignment, in numpy alone.

``posting_layout`` says which corpus row fills each posting slot;
``build_postings`` (``core/ivf.py``) gathers the payload from it.
``delta_layout`` is the host half of ``lifecycle/rebuild.py``'s
``delta_build``: it reads the stage-2 checkpoints, drops the tombstoned
rows and lays the postings out.  It runs in a child process started by
``spawn``, so this module imports nothing but numpy: a serving process
whose poller shares the interpreter lock with the rebuild thread would
otherwise wait on these reads and loops.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np


def posting_layout(assign: np.ndarray, n_clusters: int, cluster_len: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(source row (C, L) int64, ids (C, L) int32) of a (N, R) closure
    assignment.

    A cluster's members are taken column by column of ``assign`` and in
    index order within a column; clusters larger than ``cluster_len`` keep
    their first ``cluster_len`` members.  A slot past a cluster's last
    member has id -1 and repeats that member's row; a slot of an empty
    cluster has source row -1 (a zero payload).
    """
    n, r = assign.shape
    cl = assign.T.reshape(-1)                       # column-major order
    pts = np.tile(np.arange(n), r)
    keep = cl >= 0
    cl, pts = cl[keep], pts[keep]
    order = np.argsort(cl, kind="stable")
    cl, pts = cl[order], pts[order]
    starts = np.searchsorted(cl, np.arange(n_clusters))
    rank = np.arange(cl.size) - starts[cl]
    take = rank < cluster_len
    ids = np.full((n_clusters, cluster_len), -1, dtype=np.int32)
    ids[cl[take], rank[take]] = pts[take]
    fill = np.minimum(np.bincount(cl, minlength=n_clusters), cluster_len)
    last = np.maximum(fill - 1, 0)[:, None]
    slot = np.minimum(np.arange(cluster_len)[None, :], last)
    src = np.take_along_axis(ids, slot, axis=1).astype(np.int64)
    src[fill == 0] = -1
    return src, ids


def read_assign(paths: list, max_replicas: int) -> np.ndarray:
    """The stage-2 checkpoints' ``assign`` arrays, concatenated."""
    if not paths:
        return np.zeros((0, max_replicas), np.int32)
    return np.concatenate([np.load(p)["assign"] for p in paths], axis=0)


def delta_layout(paths: list, max_replicas: int,
                 tombstone: Optional[np.ndarray], n: int, n_clusters: int,
                 cluster_len: int) -> dict:
    """``read_assign``, the tombstone fold and ``posting_layout``:
    ``{"src", "ids", "folded_deletes", "assign_load_s", "layout_s"}``."""
    t0 = time.perf_counter()
    assign = read_assign(paths, max_replicas)
    t1 = time.perf_counter()
    folded_deletes = 0
    if tombstone is not None:
        dead = np.asarray(tombstone[:n], bool)
        folded_deletes = int(dead.sum())
        assign[dead] = -1              # the fold: tombstones leave postings
    src, ids = posting_layout(assign, n_clusters, cluster_len)
    return {"src": src, "ids": ids, "folded_deletes": folded_deletes,
            "assign_load_s": t1 - t0,
            "layout_s": time.perf_counter() - t1}
