"""Quickstart on the PyTorch port (the twin of ``examples/quickstart.py``):
build a Helmsman index and search it.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]
        [--n 20000] [--queries 256]

On the card the build runs the fused k-means kernels and the search the
fused f32 scan; with ``--device cpu`` their plain versions.  ``run(args)``
returns the printed numbers.
"""
import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.build.pipeline import BuildConfig, build_index
from repro_torch.core.distance import recall_at_k
from repro_torch.core.ivf import brute_force_topk
from repro_torch.core.llsp import LLSPConfig
from repro_torch.core.search import SearchConfig, serve_step
from repro_torch.data.synthetic import PAPER_DATASETS, make_queries, \
    make_vectors
from repro_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=256)
    return ap


def run(args) -> dict:
    dev = resolve_device(args.device)
    # 1. a clustered corpus + production-like queries (per-query top-k)
    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=args.n, dim=32)
    x = make_vectors(spec)
    queries, topk = make_queries(spec, args.queries)
    topk = np.minimum(topk, 50).astype(np.int32)

    # 2. three-stage build: coarse k-means -> elastic fine split + closure
    #    assignment -> merge + LLSP training
    cfg = BuildConfig(
        max_cluster_size=96, cluster_len=128, coarse_per_task=5_000,
        n_workers=2,
        llsp=LLSPConfig(levels=(8, 16, 32, 64), recall_target=0.9),
    )
    with tempfile.TemporaryDirectory() as workdir:
        index, llsp, report = build_index(x, cfg, workdir, queries=queries,
                                          query_topk=topk, device=dev)
    build_s = sum(report.stage_seconds.values())
    print(f"built {report.n_clusters} clusters "
          f"(replication {report.replication:.2f}x) in {build_s:.1f}s")

    # 3. serve a batch: router -> centroid scan -> leveling pruning -> one
    #    batched posting scan -> dedup top-k
    q = torch.from_numpy(queries).to(dev)
    # n_ratio is the pruners' trained width (the reference's 16 against
    # 32 trained ratios reads past the features: ROADMAP §3)
    out = serve_step(index, llsp, q, torch.from_numpy(topk).to(dev),
                     SearchConfig(k=10, nprobe_max=64, pruning="llsp",
                                  n_ratio=cfg.llsp.n_ratio_features))
    _, true10 = brute_force_topk(torch.from_numpy(x).to(dev), q, 10)
    recall = recall_at_k(out["ids"].cpu().numpy(), true10.cpu().numpy())
    nprobe = float(out["nprobe"].float().mean())
    print(f"recall@10 = {recall:.3f}  mean nprobe = {nprobe:.1f} / 64")
    return {"n_clusters": report.n_clusters,
            "replication": report.replication, "build_s": build_s,
            "recall": recall, "mean_nprobe": nprobe}


if __name__ == "__main__":
    run(build_parser().parse_args())
