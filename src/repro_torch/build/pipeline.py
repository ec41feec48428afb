"""3-stage construction pipeline with checkpoint/resume (port of
``repro.build.pipeline``).

Stage 1 — coarse clustering: the corpus is split into ``coarse_per_task``
chunks, each clustered by balanced hierarchical k-means.  Fused, the chunks
go in ``n_workers`` contiguous groups, one task each, whose splitters run in
lockstep (``balanced_hierarchical_kmeans_many``: one batched Lloyd launch,
K23, per step); with ``fused_assign=False`` each chunk is a task on the
unfused ``pairwise_l2`` path.  The merged centroid set is then split until
every Voronoi cell fits a posting list (fused: K2 reassignments, each
round's 2-means in one K23 launch).  Stage 2 — closure multi-cluster
assignment per shard, then the fixed-size posting build.  With
``cfg.stream_stage2`` (default) the shards run through the double-buffered
:class:`repro_torch.build.stream.ShardAssignPipeline` (shard i+1's host
slice and copy to the device under shard i's in-flight assign, each stage
stamped in ``report.shard_stamps``); otherwise as elastic tasks.  Stage 3 —
LLSP training from logged queries.

Every stage checkpoints under ``workdir``; rebuilding with the same config
resumes instead of recomputing, and the kernels' M-step is deterministic,
so a resumed build hashes equal to a fresh one (:func:`index_content_hash`),
at shard granularity inside stage 2.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.distance import squared_l2_chunked, topk_smallest
from repro_torch.core.ivf import IVFIndex, build_postings, search_flat
from repro_torch.core.llsp import LLSPConfig, LLSPParams, train_llsp
from repro_torch.core.spann_rules import closure_assign
from repro_torch.device import DeviceLike, resolve_device

from .elastic import run_tasks
from .kmeans import SplitStats, balanced_hierarchical_kmeans, \
    balanced_hierarchical_kmeans_many, enforce_size_bound
from .stream import ShardAssignPipeline, shard_overlap_efficiency


@dataclasses.dataclass
class BuildConfig:
    max_cluster_size: int = 96
    cluster_len: int = 128
    coarse_per_task: int = 10_000
    n_workers: int = 2
    closure_eps: float = 0.2
    max_replicas: int = 4
    kmeans_iters: int = 8
    seed: int = 0
    llsp: Optional[LLSPConfig] = None
    fused_assign: bool = True     # False = the reference's unfused A/B
                                  # path: pairwise_l2 tile + argmin, host
                                  # float64 M-step
    stream_stage2: bool = True    # double-buffered shard-assign pipeline
                                  # with stage stamps; False = the elastic
                                  # thread-pool tasks


@dataclasses.dataclass
class BuildReport:
    n_clusters: int
    replication: float            # mean posting slots per corpus vector
    stage_seconds: dict
    resumed_stages: list
    shard_stamps: list = dataclasses.field(default_factory=list)
    shard_overlap: float = 0.0    # measured load-under-assign fraction
    postings_s: float = 0.0       # stage 2's checkpoint reads and
                                  # build_postings, after the shards
    stage1_split: list = dataclasses.field(default_factory=list)
                                  # SplitStats per fused stage-1 group


def _chunks(n: int, per_task: int) -> list[tuple[int, int]]:
    return [(s, min(s + per_task, n)) for s in range(0, n, per_task)]


def index_content_hash(index: IVFIndex) -> str:
    """Deterministic content hash of the serving index (resume invariant);
    the same bytes hash the same as the reference's."""
    h = hashlib.sha256()
    for t in (index.centroids, index.postings, index.posting_ids):
        a = np.ascontiguousarray(t.cpu().numpy())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def build_index(
    x: np.ndarray,
    cfg: BuildConfig,
    workdir: str,
    queries: Optional[np.ndarray] = None,
    query_topk: Optional[np.ndarray] = None,
    *,
    device: DeviceLike = None,
) -> tuple[IVFIndex, Optional[LLSPParams], BuildReport]:
    """Build (or resume) the serving index on ``device`` (the CUDA card by
    default).  Returns (index on the device, llsp on the device, report)."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    os.makedirs(workdir, exist_ok=True)
    shards_dir = os.path.join(workdir, "shards")
    os.makedirs(shards_dir, exist_ok=True)
    spans = _chunks(n, cfg.coarse_per_task)
    stage_seconds: dict = {}
    resumed: list = []
    split_stats: list = []

    # ---- stage 1: coarse clustering (elastic tasks, per-chunk) -----------
    t0 = time.perf_counter()
    c_path = os.path.join(workdir, "stage1_centroids.npy")
    if os.path.exists(c_path):
        centroids = np.load(c_path)
        resumed.append("stage1")
    else:
        def mk_group(group):
            def task():
                st = SplitStats()
                res = balanced_hierarchical_kmeans_many(
                    [x[lo:hi] for _, (lo, hi) in group],
                    [cfg.seed + 1000 * i for i, _ in group],
                    cfg.max_cluster_size, iters=cfg.kmeans_iters, device=dev,
                    stats=st)
                return [c for c, _ in res], st
            return task

        def mk_stage1(i, lo, hi):
            def task():
                cents, _ = balanced_hierarchical_kmeans(
                    x[lo:hi], cfg.max_cluster_size, iters=cfg.kmeans_iters,
                    seed=cfg.seed + 1000 * i, fused=False, device=dev)
                return cents
            return task

        chunks = list(enumerate(spans))
        if cfg.fused_assign:
            n_groups = max(1, min(cfg.n_workers, len(chunks)))
            bounds = np.linspace(0, len(chunks), n_groups + 1).astype(int)
            groups = [chunks[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
            done = run_tasks([mk_group(g) for g in groups],
                             n_workers=cfg.n_workers)
            outs = [c for cents, _ in done for c in cents]
            split_stats = [st for _, st in done]
        else:
            outs = run_tasks([mk_stage1(i, lo, hi) for i, (lo, hi) in chunks],
                             n_workers=cfg.n_workers)
        centroids = np.concatenate(outs, axis=0).astype(np.float32)
        centroids = enforce_size_bound(
            x, centroids, min(cfg.max_cluster_size, cfg.cluster_len),
            seed=cfg.seed, fused=cfg.fused_assign, device=dev)
        np.save(c_path, centroids)
    n_clusters = centroids.shape[0]
    stage_seconds["stage1"] = time.perf_counter() - t0

    # ---- stage 2: closure assignment per shard + posting build -----------
    t0 = time.perf_counter()
    shard_paths = [os.path.join(shards_dir, f"assign_{i:05d}.npz")
                   for i in range(len(spans))]
    shard_stamps: list = []
    shard_overlap = 0.0
    if all(os.path.exists(p) for p in shard_paths):
        resumed.append("stage2")
    elif cfg.stream_stage2:
        pipe = ShardAssignPipeline(
            x, centroids, spans, shard_paths, eps=cfg.closure_eps,
            max_replicas=cfg.max_replicas, device=dev)
        try:
            stamps = pipe.run()
        finally:
            pipe.close()
        shard_overlap = shard_overlap_efficiency(stamps)
        shard_stamps = [t.asdict() for t in stamps]
        if any(t.resumed for t in stamps):
            resumed.append("stage2:partial")
    else:
        cj = torch.from_numpy(centroids).to(dev)

        def mk_stage2(lo, hi, path):
            def task():
                if os.path.exists(path):     # task-granular resume
                    return path
                a = closure_assign(
                    torch.from_numpy(x[lo:hi]).to(dev), cj,
                    eps=cfg.closure_eps,
                    max_replicas=cfg.max_replicas).cpu().numpy()
                tmp = path + ".tmp.npz"   # .npz suffix: savez won't append
                np.savez(tmp, assign=a)
                os.replace(tmp, path)
                return path
            return task

        run_tasks([mk_stage2(lo, hi, p)
                   for (lo, hi), p in zip(spans, shard_paths)],
                  n_workers=cfg.n_workers)
    t_post = time.perf_counter()
    assign = np.concatenate(
        [np.load(p)["assign"] for p in shard_paths], axis=0)
    postings, posting_ids = build_postings(x, assign, n_clusters,
                                           cfg.cluster_len)
    index = IVFIndex(torch.from_numpy(centroids).to(dev),
                     torch.from_numpy(postings).to(dev),
                     torch.from_numpy(posting_ids).to(dev))
    stage_seconds["stage2"] = time.perf_counter() - t0
    postings_s = time.perf_counter() - t_post

    # ---- stage 3: LLSP training from logged queries -----------------------
    t0 = time.perf_counter()
    llsp = None
    if cfg.llsp is not None and queries is not None and query_topk is not None:
        llsp = train_llsp_for_index(cfg.llsp, index, x, queries,
                                    np.asarray(query_topk), seed=cfg.seed)
    stage_seconds["stage3"] = time.perf_counter() - t0

    replication = float((posting_ids >= 0).sum()) / max(n, 1)
    report = BuildReport(n_clusters=n_clusters, replication=replication,
                         stage_seconds=stage_seconds, resumed_stages=resumed,
                         shard_stamps=shard_stamps,
                         shard_overlap=shard_overlap,
                         postings_s=postings_s, stage1_split=split_stats)
    return index, llsp, report


def train_llsp_for_index(
    llsp_cfg: LLSPConfig,
    index: IVFIndex,
    x: np.ndarray,
    queries: np.ndarray,
    query_topk: np.ndarray,
    seed: int = 0,
) -> LLSPParams:
    """Offline LLSP training: labels from a non-pruned large-nprobe search
    on the index's device; the GBDTs fit in numpy; the params come back on
    the index's device."""
    dev = index.device
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
    topk = np.asarray(query_topk, np.int64)
    nmax = min(llsp_cfg.nmax, index.n_clusters)
    cdists, cid_order = topk_smallest(
        squared_l2_chunked(q, index.centroids), nmax)
    kmax = int(topk.max())
    _, true_ids = search_flat(index, q, kmax, nprobe=nmax)
    true = true_ids.cpu().numpy()
    cols = np.arange(kmax)[None, :]
    true = np.where(cols < topk[:, None], true, -1)   # per-query k padding
    params = train_llsp(
        llsp_cfg, np.asarray(queries, np.float32), topk,
        cid_order.cpu().numpy(), cdists.cpu().numpy(), true,
        index.posting_ids.cpu().numpy(), x.shape[0], seed=seed)
    return params.to(dev)
