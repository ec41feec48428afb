#!/usr/bin/env python3
"""Two checkouts of the repository measured side by side on one card.

    python3 tools/chip_ab.py --tree OLD --tree NEW --tree NEW --tree OLD \
        [--rate 869.3] [--out FILE]

Each ``--tree`` is the root of a checkout (this one, or an unpacked
``git archive`` of another commit).  The trees run one after another, each
in a process of its own that imports that tree's ``repro_torch`` and
``chip_smoke.py`` and builds that tree's kernels.  The timers are this
script's, so every tree is read with the same yardstick:

- K1 (``ivf_scan_q8_topk``) through its wrapper ``ivf_scan_q8_topk_cuda``,
  whose signature every tree shares (on a tree whose wrapper plans on the
  host, also its kernel alone on a prebuilt plan), and B2
  (``ivf_scan_topk``) alone on a prebuilt plan and through its wrapper, on
  one synthetic batch made from a seed (B 32, P 16, 512 packed rows of L 128
  and D 128, k2 24: the shape of chip_smoke's phase 6); each timed two ways
  by ``time_two_ways`` of this checkout's ``chip_smoke.py``: CUDA events
  around n launches as they are issued ("events", the host's enqueue time
  included when it is the longer), and the same launches queued behind a
  sleep kernel ("queued", the card's time alone);
- K3 (``kmeans_mstep``) through its wrapper ``kmeans_mstep_cuda(sums,
  counts, reseed)`` at chip_smoke's ``K3_SHAPES`` (K 8, 2 and 20,614, D
  128, int32 counts) on seeded inputs, and the empty kernel's launch floor
  on a tree that has one;
- B5 (``pairwise_l2``) through its wrapper ``pairwise_l2_cuda(a, b)`` at
  16,384 x 20,614, 16,384 x 1,929 and 97 x 2 (D 128) on seeded inputs, and
  summed over every launch of the tree's own unfused 100k build (phase 10's
  configuration, the shapes recorded as it runs): each distinct shape timed
  both ways and weighted by its launches;
- B6a (``ivf_scan``), B6b (``ivf_scan_clustermajor``) and B7
  (``ivf_scan_q8``) through their wrappers on phase 7's first resident
  batch (the tree's own 1M index and LLSP plan for the first 32 of phase
  4's queries): B6b on the batch's probed-cluster union, then with every
  (cluster, query) pair selected, beside ``torch.cdist`` on the gathered
  blocks; B7 on the index's q8 payload, and at chip_smoke's ``B7_WAVES``
  (B 256, P 16, C 8192) on seeded inputs;
- the 1M build of the tree's own phase 3 and its ``index_content_hash``,
  beside the unfused and the fused 100k builds' stage seconds and hashes;
- phase 4 of the tree (the q8 streamed pipeline over 64 batches of 32:
  QPS, batch p50/p99, recall);
- run (a) of the tree's phase 11 (engine, quality stack on, one 6 s
  open-loop trace) at the fixed offered rate ``--rate`` in q/s, in place of
  a quarter of phase 4's QPS, and the 256 recall probes after it.

``--serve-only`` skips the kernel times and the 100k builds: each tree
then runs its 1M build, phase 4 and run (a) alone (about 40 s a tree).
``--b2`` times only B2 (about two minutes a tree): through its wrapper
``ivf_scan_topk_cuda`` at phase 6's serving shape (there also the kernel
alone on a prebuilt tile plan) and on one GIST bulk batch (B 4,096, P 256
with 30-256 live probes a query, 29,000 clusters of L 128 and D 960, a
quarter of the rows dead, k2 24; seeded, made on the card), with the bound
of each, the plain version's time (at the GIST batch on its first 8
queries) and the device time of the scan and merge kernels; on a tree
whose wrapper takes ``design=``, also each design over ``B2_GRID``, the
shapes that set ``b2_design``'s constants.
Prints one JSON object a tree, on a line starting ``AB``, and writes them
all to ``--out`` as a JSON list.  Needs one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _yardstick():
    """This checkout's chip_smoke.py, loaded under a name of its own, so
    every tree is timed by the same code (``time_two_ways``,
    ``b5_shape_times``) on the same inputs (``kmeans_inputs``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_yardstick", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_times(cs, time_two_ways) -> dict:
    from repro_torch.kernels import ivf_scan as scan
    from repro_torch.kernels import ivf_scan_q8 as q8m
    from repro_torch.kernels.ivf_scan import plan_tile_probes

    k2 = 24
    q8, scale, norm2, cents, ids, cids, mask, q = cs.q8_inputs(
        512, 128, 128, 32, 16, seed=1, dead=0.05, masked=0.2)
    k1 = {"wrapper": time_two_ways(lambda: q8m.ivf_scan_q8_topk_cuda(
        q8, scale, norm2, cents, ids, cids, mask, q, k2=k2), n=200)}
    # alone: on a tree whose wrapper plans on the host, the kernel on a
    # prebuilt plan; elsewhere the wrapper launches nothing but the kernels
    k1["alone"] = k1["wrapper"]
    planned = getattr(q8m, "ivf_scan_q8_topk_planned", None)
    if planned is not None:
        tc1, qs1 = plan_tile_probes(cids, mask, 1, q8.shape[0])
        qs1 = qs1.reshape(cids.shape)
        k1["alone"] = time_two_ways(lambda: planned(
            q8, scale, norm2, cents, ids, tc1, qs1, q, k2=k2), n=200)
    post, pids, cids, mask, q = cs.f32_inputs(512, 128, 128, 32, 16, seed=15,
                                              dead=0.05, masked=0.2)
    pc, pm, pq = scan._pad_tile(cids, mask, q, scan.BQ)
    tc, qs = plan_tile_probes(pc, pm, scan.BQ, post.shape[0])
    b2 = {"alone": time_two_ways(lambda: scan.ivf_scan_topk_planned(
              post, pids, tc, qs, pq, k2=k2), n=200),
          "wrapper": time_two_ways(lambda: scan.ivf_scan_topk_cuda(
              post, pids, cids, mask, q, k2=k2), n=200)}
    return {"ivf_scan_q8_topk": k1, "ivf_scan_topk": b2}


def k3_times(ys) -> dict:
    """K3 (``kmeans_mstep``) through its wrapper ``kmeans_mstep_cuda`` at
    this checkout's ``K3_SHAPES`` (int32 counts, as K2 returns them), and
    the empty kernel's launch floor where the tree has one."""
    from repro_torch.kernels import cuda_lib

    out = {"kmeans_mstep": ys.k3_shape_times(ys.time_two_ways)}
    if hasattr(cuda_lib, "launch_floor"):
        out["launch_floor"] = ys.launch_floor_times()
    return out


B5_SHAPES = {"16384x20614x128": (16384, 20614, 128),
             "16384x1929x128": (16384, 1929, 128),
             "97x2x128": (97, 2, 128)}


def b5_times(ys) -> dict:
    """B5 through the tree's wrapper at B5_SHAPES, inputs from this
    checkout's ``kmeans_inputs``."""
    from repro_torch.kernels import pairwise_l2 as pw

    out = {}
    for tag, (n, m, d) in B5_SHAPES.items():
        a, b = ys.kmeans_inputs(n, m, d, seed=n + m)
        reps = 10 if n * m > 1 << 20 else 200
        out[tag] = ys.time_two_ways(lambda: pw.pairwise_l2_cuda(a, b),
                                    n=reps, warm=2)
        out[tag]["bound_ms"] = ys.b5_bound_ms(n, m, d)
    return out


def unfused_builds(cs, ys, work: str) -> dict:
    """The tree's unfused and fused 100k builds in phase 10's
    configuration: seconds, stage seconds and hash of each, and B5 summed
    over the unfused build's launches at the shapes it recorded."""
    import numpy as np

    from repro_torch.build.pipeline import BuildConfig, build_index, \
        index_content_hash
    from repro_torch.core.llsp import LLSPConfig
    from repro_torch.data.synthetic import PAPER_DATASETS, make_queries, \
        make_vectors
    from repro_torch.kernels import pairwise_l2 as pw

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=cs.N_UNFUSED)
    x = make_vectors(spec)
    q_train, topk = make_queries(spec, 256)
    launch = pw.pairwise_l2_cuda
    shapes: dict = {}

    def recording(a, b):
        sh = (a.shape[0], b.shape[0], a.shape[1])
        shapes[sh] = shapes.get(sh, 0) + 1
        return launch(a, b)

    out = {}
    for fused in (False, True):
        cfg = BuildConfig(max_cluster_size=96, cluster_len=128,
                          coarse_per_task=5000, n_workers=2,
                          fused_assign=fused,
                          llsp=LLSPConfig(levels=(8, 16), n_ratio_features=8))
        pw.pairwise_l2_cuda = launch if fused else recording
        t0 = time.perf_counter()
        try:
            index, _, report = build_index(
                x, cfg, os.path.join(work, f"unfused-{fused}"),
                queries=q_train,
                query_topk=np.minimum(topk, 50).astype(np.int32),
                device=cs.DEVICE)
        finally:
            pw.pairwise_l2_cuda = launch
        out["fused" if fused else "unfused"] = {
            "seconds": time.perf_counter() - t0,
            "stage_seconds": dict(report.stage_seconds),
            "index_content_hash": index_content_hash(index)[:16]}
    out["b5_all_launches"] = ys.b5_shape_times(
        shapes, launch, getattr(pw, "pairwise_l2_variant", None))
    return out


def resident_scan_times(cs, ys, built) -> dict:
    """B6a, B6b and B7 on phase 7's first resident batch of the tree's 1M
    index (B6b on the batch's probed-cluster union, then with every pair
    selected, beside torch.cdist on the gathered blocks; B7 on the q8
    payload), and B7 at this checkout's ``B7_WAVES`` on seeded inputs."""
    import torch

    from repro_torch.core.quantize import attach_quantized
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.synthetic import make_queries
    from repro_torch.kernels import ivf_scan as scan
    from repro_torch.kernels import ivf_scan_q8 as q8m

    queries, _ = make_queries(built["spec"], cs.N_BATCHES * cs.BATCH, seed=7)
    qd = torch.from_numpy(queries[:cs.BATCH]).to(cs.DEVICE)
    tk = torch.full((cs.BATCH,), 10, dtype=torch.int32, device=cs.DEVICE)
    index = built["index"]
    cids, mask = cs.resident_plan(index, built["llsp"], qd, tk,
                                  SearchConfig(**cs.SERVE_CFG))
    post = index.postings
    out = {"ivf_scan": ys.time_two_ways(
        lambda: scan.ivf_scan_cuda(post, cids, mask, qd), n=100)}
    out["ivf_scan"]["live_probes"] = int(mask.sum())
    out["ivf_scan"]["unique_clusters"] = int(cids[mask].unique().numel())

    active, qsel = ys.b6b_union(cids, mask)
    out["ivf_scan_clustermajor"] = dict(
        ys.b6b_times(post, active, qsel, qd.contiguous()),
        A=active.numel(), selected_pairs=int(qsel.sum()))
    args = ys.b7_args(attach_quantized(index), cids, mask, qd)
    out["ivf_scan_q8"] = {
        "resident": ys.time_two_ways(lambda: q8m.ivf_scan_q8_cuda(*args),
                                     n=100),
        "waves": ys.b7_waves()}
    return out


B2_SERVE = (32, 16, 512, 128, 128)          # (B, P, R, L, D)
B2_GIST = (4096, 256, 29_000, 128, 960)
B2_GRID = [  # (B, P, R, L, D): B*P/R from 1/16 to 128 probes a cluster
    (32, 16, 8192, 128, 128), (512, 16, 8192, 128, 128),
    (1024, 16, 8192, 128, 128), (2048, 16, 8192, 128, 128),
    (3072, 16, 8192, 128, 128), (1024, 64, 8192, 128, 128),
    (4096, 64, 8192, 128, 128), (32, 16, 512, 128, 128),
    (128, 16, 512, 128, 128), (256, 16, 4096, 128, 256),
    (512, 16, 4096, 128, 256), (1024, 16, 4096, 128, 256),
    (128, 16, 4096, 128, 512), (256, 16, 4096, 128, 512),
    (512, 16, 4096, 128, 512), (32, 16, 4096, 128, 960),
    (64, 16, 4096, 128, 960), (128, 16, 4096, 128, 960),
    (256, 16, 4096, 128, 960), (512, 16, 4096, 128, 960),
    (2048, 256, 4096, 128, 960)]


def b2_batch(b, p, r, l, d, seed, dead=0.25):
    """Seeded B2 inputs made on the card: postings N(0, 1), ids with a
    share ``dead`` of -1, queries N(0, 1), each query's P distinct random
    clusters of which the first nprobe (uniform in [30 P / 256, P]) are
    live."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    post = torch.randn((r, l, d), generator=g, device=dev)
    ids = torch.arange(r * l, dtype=torch.int32, device=dev).reshape(r, l)
    ids[torch.rand((r, l), generator=g, device=dev) < dead] = -1
    q = torch.randn((b, d), generator=g, device=dev)
    cids = torch.rand((b, r), generator=g, device=dev).topk(
        p, dim=1).indices.to(torch.int32)
    nprobe = torch.randint(max(1, 30 * p // 256), p + 1, (b,), generator=g,
                           device=dev)
    mask = torch.arange(p, device=dev)[None, :] < nprobe[:, None]
    return post, ids, cids.contiguous(), mask, q


def b2_bound_ms(cids, mask, l, d, k2) -> dict:
    """B2's bound on one batch, as anns_bench/roofline.py ``b2_call``
    counts it: the union's rows and ids read once, the queries, the plan
    and the candidates; a dot and the combine per live (probe, row), a
    norm per union row and per query."""
    b, p = cids.shape
    probes = int(mask.sum())
    union = int(cids[mask].unique().numel())
    nbytes = (union * (l * d * 4 + 4 * l) + b * d * 4 + b * p * 5
              + b * k2 * 8)
    ops = probes * l * (2 * d + 3) + union * l * 2 * d + b * 2 * d
    t_b, t_o = nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "probes": probes, "union": union}


def _adaptive(ys, fn) -> dict:
    """time_two_ways with as many calls as fit about a second."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = max(3, min(200, int(1.0 / max(time.perf_counter() - t0, 1e-6))))
    return dict(ys.time_two_ways(fn, n=n, warm=1), n=n)


def b2_times(ys) -> dict:
    """B2 through the tree's wrapper at B2_SERVE and B2_GIST, and on a tree
    that has designs, each design over B2_GRID."""
    import inspect

    import torch

    from repro_torch.kernels import ivf_scan as scan

    k2 = 24
    designs = "design" in inspect.signature(
        scan.ivf_scan_topk_cuda).parameters
    out = {}
    for tag, shape in (("serve", B2_SERVE), ("gist", B2_GIST)):
        b, p, r, l, d = shape
        args = b2_batch(b, p, r, l, d, seed=r + b)
        row = dict(b2_bound_ms(args[2], args[3], l, d, k2),
                   wrapper=_adaptive(ys, lambda: scan.ivf_scan_topk_cuda(
                       *args, k2=k2)))
        if tag == "serve":   # the kernel alone on a prebuilt tile plan
            pc, pm, pq = scan._pad_tile(args[2], args[3], args[4], scan.BQ)
            tc, qs = scan.plan_tile_probes(pc, pm, scan.BQ, r)
            row["alone"] = ys.time_two_ways(
                lambda: scan.ivf_scan_topk_planned(args[0], args[1], tc, qs,
                                                   pq, k2=k2), n=200)
        n_plain = b if b <= 32 else 8
        row["plain_ms"] = ys.time_ms(lambda: scan.ivf_scan_topk_plain(
            args[0], args[1], args[2][:n_plain], args[3][:n_plain],
            args[4][:n_plain], k2=k2), n=3, warm=1)
        row["plain_queries"] = n_plain
        if designs:
            row["design"] = scan.b2_design(b, p, r, l, d, k2)
        try:       # device ms a launch of the scan and of the merge
            row["split_ms"] = ys.kernel_split_ms(
                lambda: scan.ivf_scan_topk_cuda(*args, k2=k2),
                ("f32_topk_kernel", "f32_topk_merge_kernel"), n=5)
        except AssertionError as e:        # a tree without a merge there
            row["split_ms"] = str(e)
        out[tag] = row
        del args
        torch.cuda.empty_cache()
    if designs:
        grid = []
        for b, p, r, l, d in B2_GRID:
            args = b2_batch(b, p, r, l, d, seed=r + b + p)
            row = {"shape": [b, p, r, l, d], "qpc": b * p / r,
                   "live_qpc": int(args[3].sum()) / r,
                   "design": scan.b2_design(b, p, r, l, d, k2)}
            for design in scan.B2_DESIGNS:
                row[design] = _adaptive(ys, lambda: scan.ivf_scan_topk_cuda(
                    *args, k2=k2, design=design))
            grid.append(row)
            del args
            torch.cuda.empty_cache()
        out["grid"] = grid
    return out


def run_one(tree: str, rate: float, serve_only: bool = False,
            b2_only: bool = False) -> dict:
    tree = os.path.abspath(tree)
    ys = _yardstick()
    time_two_ways = ys.time_two_ways
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs     # puts the tree's src/ first on sys.path

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device")
    import repro_torch
    from repro_torch.build.pipeline import index_content_hash
    from repro_torch.kernels import cuda_lib

    if not repro_torch.__file__.startswith(tree):
        raise SystemExit(f"chip_ab: imported {repro_torch.__file__}, not "
                         f"{tree}'s")
    card = cs.phase_device()["card"]
    cuda_lib.build_info()
    out = {"tree": tree, "card": card, "kernels": {}}
    if b2_only:
        out["b2"] = b2_times(ys)
        return out
    work = tempfile.mkdtemp(prefix="chip_ab_")
    if not serve_only:
        out["kernels"] = kernel_times(cs, time_two_ways)
        out["kernels"]["pairwise_l2"] = b5_times(ys)
        out["kernels"].update(k3_times(ys))
        out["unfused_100k"] = unfused_builds(cs, ys, work)
    built = cs.phase_build(work)
    out["build_s"] = built["build_s"]
    out["index_content_hash"] = index_content_hash(built["index"])[:16]
    if not serve_only:
        out["kernels"].update(resident_scan_times(cs, ys, built))
    # phase 4: the q8 streamed pipeline, closed loop (QPS, batch latency)
    served = cs.phase_serve(work, built)
    out["phase4"] = {k: served[k] for k in ("qps", "p50_ms", "p99_ms",
                                            "recall10", "probe_ceiling")}
    served["pipe"].close()
    served["pipe"].flash.release()
    # run (a) alone, offered ``rate`` q/s: phase_engine offers 0.25x the
    # "QPS" it is handed
    cs.ENGINE_RUNS = tuple(r for r in cs.ENGINE_RUNS if r[0] == "a")
    eng = cs.phase_engine(work, built, {"qps": rate / 0.25})
    keep = ("offered_qps", "arrived_qps", "completed_qps", "p50_ms",
            "p99_ms", "completed", "batches", "mean_batch", "device_busy",
            "drain_s", "max_queue_wait_ms", "service_p50_ms",
            "service_p99_ms", "audits", "stage_ms")
    out["engine_a"] = {k: eng["a"][k] for k in keep if k in eng["a"]}
    out["engine_probe"] = eng["probe"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--rate", type=float, default=869.3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--serve-only", action="store_true",
                    help="only the build, phase 4 and the engine run (a)")
    ap.add_argument("--b2", action="store_true",
                    help="only B2's times (serving, GIST, design grid)")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print("AB " + json.dumps(run_one(a.one, a.rate, a.serve_only,
                                         a.b2)), flush=True)
        return 0
    if not a.tree:
        ap.error("give at least one --tree")
    results = []
    for tree in a.tree:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree, "--rate", str(a.rate)]
                           + ["--serve-only"] * a.serve_only
                           + ["--b2"] * a.b2,
                           capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode or not lines:
            print(p.stdout[-4000:])
            print(f"chip_ab: {tree} failed (exit {p.returncode})")
            return 1
        res = json.loads(lines[-1][3:])
        res["seconds"] = time.perf_counter() - t0
        print(lines[-1], flush=True)
        results.append(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
