"""Retrieval model + Helmsman integration on the PyTorch port (the twin of
``examples/train_retrieval.py``; paper §2.1 Rec/Ads pipeline).

Trains a reduced MIND multi-interest retrieval model on synthetic click
logs, exports the learned item-embedding table, builds a Helmsman index
over the learned embeddings (the paper's "embedding models are updated in
batches ... up to ten thousand index rebuilds per day" flow), and serves
each interest vector as an ANNS query through ``serve_step`` (on the card
the f32 fused scan), comparing recall against brute-force L2 truth and
against the probe ceiling: the recall of an exact scan over the very
clusters each query probed, which an exact f32 scan must reach.

    PYTHONPATH=src python examples/train_retrieval_torch.py [--steps 200]
        [--items 8192] [--device cuda|cpu]
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.build.pipeline import BuildConfig, build_index
from repro_torch.core.distance import recall_at_k
from repro_torch.core.ivf import brute_force_topk
from repro_torch.core.search import SearchConfig, centroid_scan, serve_step
from repro_torch.device import resolve_device
from repro_torch.models.recsys import RecSysConfig, init_params, \
    make_train_step
from repro_torch.models.recsys.models import capsule_routing
from repro_torch.optim import adamw


def make_structured_batch(b, n_items, seq_len, n_groups=32, seed=0):
    """Synthetic logs with latent interest groups: each user draws history
    from a few groups; the label is 1 iff the target item belongs to one of
    the user's groups — so MIND must learn the group structure."""
    rng = np.random.default_rng(seed)
    group_of = np.arange(n_items) % n_groups
    user_groups = rng.integers(0, n_groups, size=(b, 3))
    hist = np.empty((b, seq_len), np.int32)
    for i in range(b):
        gs = user_groups[i][rng.integers(0, 3, seq_len)]
        hist[i] = gs + n_groups * rng.integers(0, n_items // n_groups, seq_len)
    pos = rng.random(b) < 0.5
    target = np.where(
        pos,
        user_groups[np.arange(b), rng.integers(0, 3, b)]
        + n_groups * rng.integers(0, n_items // n_groups, b),
        rng.integers(0, n_items, b),
    ).astype(np.int32)
    labels = (group_of[target][:, None] == user_groups).any(1).astype(np.float32)
    return {"sparse_ids": target[:, None], "hist_ids": hist,
            "hist_len": np.full(b, seq_len, np.int32), "labels": labels}


def probe_ceiling(cids: np.ndarray, nprobe: np.ndarray,
                  posting_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Recall@k of an exact scan over the first nprobe[b] clusters of
    cids[b] for every query b."""
    hits = 0
    for b in range(len(cids)):
        probed = posting_ids[cids[b, : nprobe[b]]].ravel()
        hits += int(np.isin(true_ids[b], probed).sum())
    return hits / true_ids.size


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--items", type=int, default=8192)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain torch path)")
    return ap


def run(args) -> dict:
    """Train, rebuild and serve; returns the printed numbers."""
    dev = resolve_device(args.device)
    tensors = lambda b: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    cfg = RecSysConfig("mind", "mind", n_sparse=1, embed_dim=32,
                       table_rows=args.items, seq_len=20, n_interests=4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    # retrieval towers need O(1)-norm embeddings: the capsule squash kills
    # gradients at tiny norms (default table init is 1/sqrt(rows))
    params["table"] = params["table"] * (0.5 * np.sqrt(args.items)
                                         / np.sqrt(cfg.embed_dim))
    opt_cfg = adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
    step = make_train_step(cfg, opt_cfg=opt_cfg)
    opt = adamw.init(params)

    t0 = time.perf_counter()
    for s in range(args.steps):
        batch = tensors(make_structured_batch(256, args.items, cfg.seq_len,
                                              seed=s))
        params, opt, m = step(params, opt, batch)
        if s % 50 == 0:
            print(f"[train] step {s:4d} loss={float(m['loss']):.4f} "
                  f"({time.perf_counter()-t0:.1f}s)")
    train_s = time.perf_counter() - t0
    loss = float(m["loss"])
    print(f"[train] {args.steps} steps in {train_s:.1f}s "
          f"(final loss {loss:.3f})")

    # ---- daily-rebuild flow: index the LEARNED item embeddings ------------
    table = params["table"]
    items = table.cpu().numpy().astype(np.float32)
    bcfg = BuildConfig(max_cluster_size=64, cluster_len=96,
                       coarse_per_task=2048, n_workers=2)
    # training queries for LLSP: user interest vectors from real batches
    qs = []
    with torch.no_grad():
        for s in range(4):
            b = tensors(make_structured_batch(64, args.items, cfg.seq_len,
                                              seed=999 + s))
            hist = table[b["hist_ids"].long()]
            hmask = (torch.arange(cfg.seq_len, device=dev)[None, :]
                     < b["hist_len"][:, None])
            interests = capsule_routing(hist, hmask, params["bilinear"], cfg)
            qs.append(interests.reshape(-1, cfg.embed_dim))
    queries = torch.cat(qs)
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        index, _, report = build_index(items, bcfg, wd, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        print(f"[rebuild] {report.n_clusters} clusters over learned "
              f"embeddings in {build_s:.1f}s")

    # ---- serve: each interest vector is a Helmsman query ------------------
    k = 50
    qj = queries[:256].contiguous()
    # a small corpus may hold fewer clusters than nprobe_max (at 1,024
    # items, 24): probe at most all of them (the reference's example
    # raises there, in lax.top_k)
    scfg = SearchConfig(k=k, nprobe_max=min(32, report.n_clusters),
                        pruning="fixed", eps=0.2)
    out = serve_step(index, None, qj,
                     torch.full((256,), k, dtype=torch.int32, device=dev),
                     scfg)
    # Helmsman ranks by L2: compare on brute-force L2 truth
    _, true_ids = brute_force_topk(table, qj, k)
    true_ids = true_ids.cpu().numpy()
    r = recall_at_k(out["ids"].cpu().numpy(), true_ids)
    nprobe = out["nprobe"].cpu().numpy()
    _, cids = centroid_scan(index, qj, scfg.nprobe_max, scfg)
    ceiling = probe_ceiling(cids.cpu().numpy(), nprobe,
                            index.posting_ids.cpu().numpy(), true_ids)
    scanned = float(nprobe.mean()) * index.cluster_len
    print(f"[serve] interest-query recall@{k} = {r:.3f} (probe ceiling "
          f"{ceiling:.3f}) scanning {scanned:.0f}/{args.items} items "
          f"({scanned/args.items:.1%} of an exhaustive scan)")
    return {"final_loss": loss, "train_s": train_s,
            "n_clusters": report.n_clusters, "build_s": build_s,
            "recall": r, "ceiling": ceiling, "scanned": scanned,
            "scanned_frac": scanned / args.items, "items": args.items,
            "steps": args.steps, "device": str(dev)}


def main():
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
