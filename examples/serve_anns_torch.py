"""End-to-end serving driver on the PyTorch port (the twin of
``examples/serve_anns.py``).

Builds a Helmsman index, then serves batched online traffic:
  * mixed per-query top-k sampled from the production trace distribution,
  * LLSP routing + pruning per batch,
  * rolling throughput / latency / recall reporting,
  * a mid-run posting-shard failure with replica failover (logical
    shards).

    PYTHONPATH=src python examples/serve_anns_torch.py [--batches 20]
        [--batch 256] [--n 20000] [--device cuda|cpu]

``run(args)`` returns the printed numbers.
"""
import argparse
import dataclasses
import tempfile
import time

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
from repro_torch.distributed import ownership_mask, plan_failover
from repro_torch.storage import make_replica_map, plan_striping


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--device", default="cuda")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args) -> dict:
    dev = resolve_device(args.device)
    spec = dataclasses.replace(PAPER_DATASETS["redsrch"], n=args.n, dim=32)
    x = make_vectors(spec)
    bcfg = BuildConfig(max_cluster_size=96, cluster_len=128,
                       coarse_per_task=5_000, n_workers=2,
                       llsp=LLSPConfig(levels=(8, 16, 32, 64)))
    qtrain, ktrain = make_queries(spec, 512)
    ktrain = np.minimum(ktrain, 50).astype(np.int32)
    with tempfile.TemporaryDirectory() as wd:
        index, llsp, report = build_index(x, bcfg, wd, queries=qtrain,
                                          query_topk=ktrain, device=dev)
    print(f"[build] {report.n_clusters} clusters, "
          f"{sum(report.stage_seconds.values()):.1f}s")

    # logical shard layout + hot-cluster replication (§6.2)
    n_shards = 8
    striping = plan_striping(index.n_clusters, n_shards)
    hot = np.arange(index.n_clusters)[::3]  # stride coprime w/ 8 shards
    rmap = make_replica_map(index.n_clusters, n_shards, striping,
                            hot_clusters=hot, n_replicas=2)

    # n_ratio is the pruners' trained width (the reference's 16 against
    # 32 trained ratios reads past the features: ROADMAP §3)
    scfg = SearchConfig(k=10, nprobe_max=64, pruning="llsp",
                        n_ratio=bcfg.llsp.n_ratio_features)
    xd = torch.from_numpy(x).to(dev)
    lat, thr, recs = [], [], []
    failover = None
    for b in range(args.batches):
        q, k = make_queries(spec, args.batch, seed=1000 + b)
        k = np.minimum(k, 50).astype(np.int32)
        qd, kd = torch.from_numpy(q).to(dev), torch.from_numpy(k).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        out = serve_step(index, llsp, qd, kd, scfg)
        _sync(dev)
        dt = time.perf_counter() - t0
        lat.append(dt / args.batch * 1e6)
        thr.append(args.batch / dt)
        if b % 5 == 0:
            _, t10 = brute_force_topk(xd, qd, 10)
            r = recall_at_k(out["ids"].cpu().numpy(), t10.cpu().numpy())
            recs.append(r)
            print(f"[serve] batch {b:3d}  {thr[-1]:8.0f} q/s  "
                  f"{lat[-1]:7.1f} us/q  recall@10={r:.3f}  "
                  f"mean nprobe={float(out['nprobe'].float().mean()):.1f}")
        if b == args.batches // 2:
            # shard 2 dies: replicas keep hot clusters alive
            plan = plan_failover(rmap, [2])
            ownership_mask(plan.owner, n_shards)
            failover = {"moved": len(plan.moved), "lost": plan.n_lost}
            print(f"[fault] shard 2 failed -> {len(plan.moved)} clusters "
                  f"served from replicas, {plan.n_lost} cold clusters lost "
                  f"({plan.n_lost / index.n_clusters:.1%} of index) until "
                  f"re-replication")
    res = {"mean_us_per_query": float(np.mean(lat)),
           "p99_us_per_query": float(np.percentile(lat, 99)),
           "qps": float(np.mean(thr)), "recall": float(np.mean(recs)),
           "n_clusters": index.n_clusters, "failover": failover}
    print(f"[done] mean latency {res['mean_us_per_query']:.1f} us/q, "
          f"p99 {res['p99_us_per_query']:.1f} us/q (per-batch amortized), "
          f"throughput {res['qps']:.0f} q/s, recall {res['recall']:.3f}")
    return res


if __name__ == "__main__":
    run(build_parser().parse_args())
