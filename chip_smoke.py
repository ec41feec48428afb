#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. kernels: builds the CUDA library from ``src/repro_torch/csrc`` and holds
   each kernel (q8 fused scan K1, k-means assign/update K2, k-means M-step
   K3) against its plain torch version on the card, at the main path's
   shapes and at ragged ones;
3. build: builds a SIFT1M-sized index (1,000,000 x 128, the
   ann-benchmarks sift-128-euclidean base size) with the port's own
   ``build_index`` (launch serve settings: max_cluster_size 96,
   cluster_len 128, LLSP levels (8, 16), 8 ratio features);
4. serve: ``make_quantized_pipeline`` with the flash re-rank, warmup, then
   ``run_pipelined(depth=2)`` over 64 batches of 32 queries; recall@10
   against brute force on the card; K1's launches must equal the scan
   dispatches;
5. parity: a subset of those batches through the same pipeline on the CPU
   (plain versions) must give the same ids up to ties;
6. kernel times at the main path's shapes (CUDA events), printed as one
   JSON line with each kernel's launches, time, bound and plain time.

The last line of standard output is the device JSON; the script exits
non-zero, printing no result, when there is no CUDA device or when it runs
outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
Q8_TOL = 1e-3                    # candidate tolerance of the q8 scan
N_BASE = 1_000_000
N_BATCHES = 64
BATCH = 32
PARITY_BATCHES = 8
DEVICE = "cuda"                  # the serving device of phases 3 and 4


def log(*a) -> None:
    print(*a, flush=True)


# --------------------------------------------------------------------------
# comparison helpers
# --------------------------------------------------------------------------
def candidates_match(gd, gi, wd, wi, tol: float, what: str) -> float:
    """Distances elementwise within tol; ids equal except inside groups of
    tied distances, where the id sets must agree.  Returns max |gd - wd|
    over finite entries."""
    import numpy as np

    gd, gi, wd, wi = (np.asarray(a) for a in (gd, gi, wd, wi))
    if gd.shape != wd.shape:
        raise AssertionError(f"{what}: shape {gd.shape} vs {wd.shape}")
    fin = np.isfinite(wd)
    if not np.array_equal(fin, np.isfinite(gd)):
        raise AssertionError(f"{what}: finite pattern differs")
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=tol, atol=tol * 10,
                               err_msg=what)
    for r in range(gd.shape[0]):
        for j in range(gd.shape[1]):
            if not fin[r, j]:
                if gi[r, j] != -1 or wi[r, j] != -1:
                    raise AssertionError(f"{what}: pad id at {(r, j)}")
                continue
            tied = np.isclose(wd[r], wd[r, j], rtol=tol, atol=tol * 10)
            if tied.sum() == 1:
                if gi[r, j] != wi[r, j]:
                    raise AssertionError(f"{what}: id at {(r, j)}")
            elif set(gi[r][tied].tolist()) != set(wi[r][tied].tolist()):
                raise AssertionError(f"{what}: tied ids at {(r, j)}")
    return float(np.abs(gd[fin] - wd[fin]).max()) if fin.any() else 0.0


def time_ms(fn, n: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


# --------------------------------------------------------------------------
# inputs at the kernels' shapes
# --------------------------------------------------------------------------
def q8_inputs(rows, l, d, b, p, *, seed, dead=0.0, masked=0.0, dup=False,
              device="cuda"):
    """Packed q8 rows (as the host tier streams them) and a probe plan."""
    import numpy as np
    import torch

    from repro_torch.core.quantize import quantize_postings

    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(rows, d)).astype(np.float32)
    post = cents[:, None, :] + 0.3 * rng.normal(size=(rows, l, d)).astype(
        np.float32)
    ids = rng.permutation(rows * l * 2)[: rows * l].reshape(rows, l)
    ids = ids.astype(np.int32)
    if dead:
        ids[rng.random(ids.shape) < dead] = -1
    ids[-1] = -1                                     # sentinel row
    qp = quantize_postings(torch.from_numpy(post), torch.from_numpy(cents),
                           torch.from_numpy(ids))
    q8 = qp.q8.numpy().copy()
    q8[ids < 0] = rng.integers(-128, 127, size=(int((ids < 0).sum()), d))
    queries = (cents[rng.integers(0, rows - 1, size=b)]
               + 0.3 * rng.normal(size=(b, d))).astype(np.float32)
    cids = rng.integers(0, rows - 1, size=(b, p)).astype(np.int32)
    if dup:
        cids[:, 1] = cids[:, 0]
    mask = rng.random((b, p)) >= masked
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(q8), t(qp.scale.numpy()), t(qp.norm2.numpy()), t(cents), t(ids),
            t(cids), t(mask), t(queries))


def kmeans_inputs(n, k, d, *, seed, device="cuda"):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    modes = rng.normal(size=(max(k // 4, 1), d)).astype(np.float32)
    x = modes[rng.integers(0, len(modes), size=n)] \
        + 0.25 * rng.normal(size=(n, d)).astype(np.float32)
    cents = x[rng.choice(n, size=k, replace=k > n)]
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(np.ascontiguousarray(cents)).to(device))


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------
def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    return {"card": card, "name": name}


# --------------------------------------------------------------------------
# phase 2: build the kernels and hold each against its plain version
# --------------------------------------------------------------------------
def check_k1(case: str, k2: int, *args) -> float:
    import torch

    from repro_torch.kernels import ivf_scan_q8 as q8mod

    gd, gi = q8mod.ivf_scan_q8_topk_cuda(*args, k2=k2)
    wd, wi = q8mod.ivf_scan_q8_topk_plain(*args, k2=k2)
    torch.cuda.synchronize()
    err = candidates_match(gd.cpu(), gi.cpu(), wd.cpu(), wi.cpu(), Q8_TOL,
                           f"K1 {case}")
    log(f"[kernels] K1 {case}: ok max_abs_err={err:.3g}")
    return err


def check_k2(case: str, x, cents) -> float:
    import numpy as np
    import torch

    from repro_torch.kernels import kmeans_assign as am

    a, md, sums, counts = am.kmeans_assign_update_cuda(x, cents)
    a2, md2, sums2, counts2 = am.kmeans_assign_update_cuda(x, cents)
    pa, pmd, _, _ = am.kmeans_assign_update_plain(x, cents)
    torch.cuda.synchronize()
    for u, v in ((a, a2), (md, md2), (sums, sums2), (counts, counts2)):
        if not torch.equal(u, v):
            raise AssertionError(f"K2 {case}: not deterministic run to run")
    a_np, pa_np = a.cpu().numpy(), pa.cpu().numpy()
    xf = x.double()
    cf = cents.double()
    diff = np.nonzero(a_np != pa_np)[0]
    if diff.size:
        idx = torch.from_numpy(diff).to(x.device)
        dk = ((xf[idx] - cf[a[idx].long()]) ** 2).sum(1)
        dp = ((xf[idx] - cf[pa[idx].long()]) ** 2).sum(1)
        scale = (xf[idx] ** 2).sum(1) + 1.0
        if not bool(((dk - dp).abs() <= 1e-5 * scale).all()):
            raise AssertionError(f"K2 {case}: {diff.size} assignments differ "
                                 f"beyond ties")
    md_err = float((md.double() - pmd.double()).abs().max())
    tol = 1e-5 * float((xf ** 2).sum(1).max() + 1.0)
    if md_err > tol:
        raise AssertionError(f"K2 {case}: min_dist err {md_err} > {tol}")
    k = cents.shape[0]
    al = a.long()
    ref_counts = torch.bincount(al, minlength=k)
    if not torch.equal(ref_counts.to(torch.int32), counts):
        raise AssertionError(f"K2 {case}: counts disagree with assign")
    ref_sums = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                           device=x.device).index_add_(0, al, xf)
    s_err = float((sums.double() - ref_sums).abs().max())
    s_tol = 1e-5 * float(x.abs().max() + 1.0) * float(ref_counts.max())
    if s_err > s_tol:
        raise AssertionError(f"K2 {case}: sums err {s_err} > {s_tol}")
    log(f"[kernels] K2 {case}: ok ties={diff.size} md_err={md_err:.3g} "
        f"sums_err={s_err:.3g}")
    return max(md_err, s_err)


def check_k3(case: str, sums, counts, reseed) -> float:
    import torch

    from repro_torch.kernels import kmeans_mstep as mm

    got = mm.kmeans_mstep_cuda(sums, counts, reseed)
    want = mm.kmeans_mstep_plain(sums, counts, reseed)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K3 {case}: not bit-equal to the plain version")
    log(f"[kernels] K3 {case}: ok (bit-equal)")
    return 0.0


def k3_inputs(k, d, n_empty, *, seed, int_counts=False):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sums = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
    counts = rng.integers(1, 50, size=k)
    counts[rng.choice(k, size=n_empty, replace=False)] = 0
    counts = torch.from_numpy(counts.astype(
        np.int32 if int_counts else np.float32))
    reseed = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
    return sums.cuda(), counts.cuda(), reseed.cuda()


def phase_kernels() -> dict:
    """Returns each kernel's largest error against its plain version."""
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    info = cuda_lib.build_info()
    log(f"[kernels] library {info.path} built in {info.seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)")
    if info.log:
        log(info.log)
    errs = {"ivf_scan_q8_topk": 0.0, "kmeans_assign_update": 0.0,
            "kmeans_mstep": 0.0}

    def k1(case, k2, *shape, **kw):
        e = check_k1(case, k2, *q8_inputs(*shape, **kw))
        errs["ivf_scan_q8_topk"] = max(errs["ivf_scan_q8_topk"], e)

    k1("main 512x128x128 B32 P16", 24, 512, 128, 128, 32, 16, seed=1,
       dead=0.05, masked=0.2)
    k1("ragged B13 dead+masked+dup", 24, 40, 48, 24, 13, 7, seed=2,
       dead=0.3, masked=0.3, dup=True)
    k1("k2 > live candidates", 200, 9, 16, 32, 5, 3, seed=3, dead=0.5,
       masked=0.5)
    k1("D=1024 L=64 k2=256", 256, 20, 64, 1024, 3, 4, seed=4, dead=0.1)

    def k2(case, n, k, d, seed):
        e = check_k2(case, *kmeans_inputs(n, k, d, seed=seed))
        errs["kmeans_assign_update"] = max(errs["kmeans_assign_update"], e)

    k2("splitter 5000x8x128", 5000, 8, 128, 5)
    k2("size-bound 1000000x14000x128", N_BASE, 14000, 128, 6)
    k2("ragged 2049x65x3", 2049, 65, 3, 7)
    k2("ragged 1x1x5", 1, 1, 5, 8)
    k2("K > N 100x300x20", 100, 300, 20, 9)
    # exact ties: duplicated centroids must resolve to the lower index
    import torch
    x, c = kmeans_inputs(3000, 16, 64, seed=10)
    c = torch.cat([c, c], dim=0).contiguous()
    check_k2("duplicated centroids", x, c)
    from repro_torch.kernels import kmeans_assign as am
    a, *_ = am.kmeans_assign_update_cuda(x, c)
    if int(a.max()) >= 16:
        raise AssertionError("K2: a tie went to the higher index")

    for case, args in (("main K8 D128", k3_inputs(8, 128, 2, seed=11)),
                       ("K14000 many empty", k3_inputs(14000, 128, 900,
                                                       seed=12)),
                       ("int counts K1", k3_inputs(1, 7, 1, seed=13,
                                                   int_counts=True)),
                       ("ragged K65 D3", k3_inputs(65, 3, 20, seed=14))):
        check_k3(case, *args)
    return errs


# --------------------------------------------------------------------------
# phase 3: build a SIFT1M-sized index with the port
# --------------------------------------------------------------------------
def phase_build(work: str) -> dict:
    import numpy as np

    from repro_torch.build.pipeline import BuildConfig, build_index
    from repro_torch.core.llsp import LLSPConfig
    from repro_torch.data.synthetic import PAPER_DATASETS, make_queries, \
        make_vectors
    from repro_torch.kernels.cuda_lib import LAUNCHES

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=N_BASE)
    t0 = time.perf_counter()
    x = make_vectors(spec)
    q_train, topk = make_queries(spec, 256)
    log(f"[build] corpus {x.shape} made in {time.perf_counter() - t0:.1f} s")
    cfg = BuildConfig(max_cluster_size=96, cluster_len=128,
                      coarse_per_task=5000, n_workers=2,
                      llsp=LLSPConfig(levels=(8, 16), n_ratio_features=8))
    LAUNCHES.reset()
    t0 = time.perf_counter()
    index, llsp, report = build_index(
        x, cfg, os.path.join(work, "build"), queries=q_train,
        query_topk=np.minimum(topk, 50).astype(np.int32), device=DEVICE)
    build_s = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    log(f"[build] {build_s:.1f} s stages "
        + " ".join(f"{k}={v:.1f}s" for k, v in report.stage_seconds.items())
        + f" n_clusters={report.n_clusters} "
          f"replication={report.replication:.4f} launches={launches}")
    for name in ("kmeans_assign_update", "kmeans_mstep"):
        if launches[name] < 1:
            raise AssertionError(f"build never launched {name}")
    if llsp is None:
        raise AssertionError("build trained no LLSP models")
    return {"x": x, "spec": spec, "index": index, "llsp": llsp,
            "report": report, "build_s": build_s, "launches": launches}


# --------------------------------------------------------------------------
# phase 4: serve through the q8 pipeline
# --------------------------------------------------------------------------
SERVE_CFG = dict(k=10, nprobe_max=16, pruning="llsp", n_ratio=8)


def phase_serve(work: str, built: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.ivf import brute_force_topk
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.synthetic import make_queries
    from repro_torch.kernels.cuda_lib import LAUNCHES
    from repro_torch.runtime.pipeline import (
        make_quantized_pipeline, overlap_efficiency,
        rerank_overlap_efficiency)

    x = built["x"]
    queries, _ = make_queries(built["spec"], N_BATCHES * BATCH, seed=7)
    batches = [(queries[i:i + BATCH], np.full(BATCH, 10, np.int32))
               for i in range(0, len(queries), BATCH)]
    scfg = SearchConfig(**SERVE_CFG)
    pipe = make_quantized_pipeline(
        built["index"], built["llsp"], scfg, vectors=x,
        flash_path=os.path.join(work, "flash-gpu.f32"), device=DEVICE)
    warm = pipe.warmup()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    out = pipe.run_pipelined(batches, depth=2)
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    ids = np.concatenate([o.ids for o in out])
    nprobe = np.concatenate([o.nprobe for o in out])
    if ids.shape != (len(queries), 10) or (ids < 0).any():
        raise AssertionError(f"served ids malformed: {ids.shape}")
    dists = np.concatenate([o.dists for o in out])
    if not np.isfinite(dists).all():
        raise AssertionError("served distances not finite")
    if launches["ivf_scan_q8_topk"] != len(batches):
        raise AssertionError(f"K1 launched {launches['ivf_scan_q8_topk']} "
                             f"times for {len(batches)} scan dispatches")
    _, true10 = brute_force_topk(torch.from_numpy(x).to(DEVICE),
                                 torch.from_numpy(queries).to(DEVICE), 10)
    true10 = true10.cpu().numpy()
    recall = recall_at_k(ids, true10)
    ceiling = probe_ceiling(pipe, batches, nprobe, true10)
    times = [o.times for o in out]
    lat = np.array([t.total for t in times]) * 1e3
    res = {"qps": len(queries) / wall, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "recall10": recall,
           "probe_ceiling": ceiling,
           "overlap": overlap_efficiency(times),
           "rerank_overlap": rerank_overlap_efficiency(times),
           "mean_nprobe": float(nprobe.mean()),
           "union_rows": float(np.mean([t.union_clusters for t in times])),
           "k1_launches": launches["ivf_scan_q8_topk"],
           "n_batches": len(batches), "warm": warm}
    for stage, a, b in (("plan", "plan_start", "plan_end"),
                        ("gather", "gather_start", "gather_end"),
                        ("stream", "gather_end", "stream_end"),
                        ("scan", "scan_dispatch", "scan_done"),
                        ("rerank", "rerank_start", "rerank_end")):
        res[f"{stage}_ms"] = float(np.mean(
            [getattr(t, b) - getattr(t, a) for t in times]) * 1e3)
    res.update(profile_window(pipe, batches[:16]))
    log("[serve] " + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in res.items()))
    if recall < 0.95 * ceiling:
        raise AssertionError(f"recall@10 {recall} below 0.95 x the probe "
                             f"ceiling {ceiling}")
    return {"pipe": pipe, "batches": batches, "out": out, "true10": true10,
            **res}


def profile_window(pipe, batches) -> dict:
    """Device busy share and the top kernels by device time over a short
    pipelined window, from torch.profiler (CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run_pipelined(batches, depth=2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA"))
    if not spans:
        log("[profile] no device activity recorded: busy share not measured")
        return {"device_busy": -1.0}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    top = sorted(prof.key_averages(),
                 key=lambda k: -getattr(k, "self_device_time_total", 0.0))
    log("[profile] top device time over "
        f"{len(batches)} batches ({wall_us / 1e3:.1f} ms wall): " + "; ".join(
            f"{k.key[:60]} {getattr(k, 'self_device_time_total', 0.0) / 1e3:.3f} ms"
            for k in top[:8]))
    return {"device_busy": busy / wall_us}


def probe_ceiling(pipe, batches, nprobe, true10) -> float:
    """Recall@10 of an exact scan over the very clusters each query
    probed: the most any first pass plus re-rank could reach with this plan
    (the plan is recomputed with ``route``, which must repeat it)."""
    import numpy as np

    cids = np.concatenate([pipe.route(q, tk)[0] for q, tk in batches])
    routed_np = np.concatenate([pipe.route(q, tk)[1] for q, tk in batches])
    if not np.array_equal(routed_np, nprobe):
        raise AssertionError("route() disagrees with the served plan")
    pids = pipe.tier.posting_ids
    hits = 0
    for b in range(len(cids)):
        probed = pids[cids[b, : nprobe[b]]].ravel()
        hits += int(np.isin(true10[b], probed).sum())
    return hits / true10.size


# --------------------------------------------------------------------------
# phase 5: the same pipeline on the CPU (plain versions) must agree
# --------------------------------------------------------------------------
def phase_parity(work: str, built: dict, served: dict) -> dict:
    import numpy as np

    from repro_torch.core.distance import recall_at_k
    from repro_torch.core.search import SearchConfig
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    cpu = make_quantized_pipeline(
        built["index"].to("cpu"), built["llsp"].to("cpu"),
        SearchConfig(**SERVE_CFG), vectors=built["x"],
        flash_path=os.path.join(work, "flash-cpu.f32"), device="cpu")
    sub = served["batches"][:PARITY_BATCHES]
    got = cpu.run_pipelined(sub, depth=2)
    cpu.close()
    c_ids = np.concatenate([o.ids for o in got])
    c_d = np.concatenate([o.dists for o in got])
    c_np = np.concatenate([o.nprobe for o in got])
    g = served["out"][:PARITY_BATCHES]
    g_ids = np.concatenate([o.ids for o in g])
    g_d = np.concatenate([o.dists for o in g])
    g_np = np.concatenate([o.nprobe for o in g])
    same_np = c_np == g_np
    flips = int((~same_np).sum())
    if flips > 0.02 * len(c_np):
        raise AssertionError(f"LLSP nprobe differs on {flips} queries")
    keep = np.nonzero(same_np)[0]
    candidates_match(c_d[keep], c_ids[keep], g_d[keep], g_ids[keep], 1e-5,
                     "CPU vs GPU pipeline ids")
    true = served["true10"][: len(c_ids)]
    gap = abs(recall_at_k(c_ids, true) - recall_at_k(g_ids, true))
    log(f"[parity] {len(c_ids)} queries: nprobe flips={flips}, ids match "
        f"up to ties on the rest, recall gap={gap:.4g}")
    if gap > 0.005:
        raise AssertionError(f"CPU/GPU recall gap {gap} > 0.005")
    return {"flips": flips, "recall_gap": gap}


# --------------------------------------------------------------------------
# phase 6: kernel times at the main path's shapes
# --------------------------------------------------------------------------
def phase_times(built: dict, served: dict, kernel_errs: dict) -> list:
    import numpy as np
    import torch

    from repro_torch.core.search import _auto_ncand
    from repro_torch.kernels import ivf_scan_q8 as q8m
    from repro_torch.kernels import kmeans_assign as am
    from repro_torch.kernels import kmeans_mstep as mm

    rows = []
    pipe = served["pipe"]
    # K1: one real batch of the serving run (its plan and streamed union)
    queries, topk = served["batches"][0]
    plan = pipe.plan(queries, topk)
    fetched = pipe._gather(plan)
    pmask = torch.from_numpy(plan.pmask).cuda()
    args = (*fetched.tensors(), pmask, plan.queries_dev)
    k2 = _auto_ncand(pipe.cfg.k)
    ms = time_ms(lambda: q8m.ivf_scan_q8_topk_cuda(*args, k2=k2), n=200)
    plain = time_ms(lambda: q8m.ivf_scan_q8_topk_plain(*args, k2=k2), n=20)
    _, l, d = fetched.q8.shape
    remap = fetched.remap.cpu().numpy()
    live = plan.pmask & (remap >= 0)
    qi, pi = np.nonzero(live)
    pairs = len(set(zip(qi.tolist(), remap[qi, pi].tolist())))
    used = np.unique(remap[live]).size
    b = plan.queries_dev.shape[0]
    nbytes = used * (l * d + 8 * l + 4 + 4 * d) + b * d * 4 \
        + plan.pmask.size * 5 + b * k2 * 8
    flops = pairs * (2 * l * d + 4 * l + 3 * d)
    rows.append(_row("ivf_scan_q8_topk", "src/repro_torch/csrc/ivf_scan_q8.cu",
                     "src/repro/kernels/ivf_scan_q8.py:174",
                     served["k1_launches"], kernel_errs["ivf_scan_q8_topk"],
                     ms, plain, nbytes, flops,
                     "no single PyTorch call computes a unique-by-id top-k2 "
                     "over int8 residual codes",
                     f"B={b} P={plan.pmask.shape[1]} R={fetched.q8.shape[0]} "
                     f"used_rows={used} L={l} D={d} k2={k2}"))
    # K2: the build's largest call, all points against the final centroids
    x = torch.from_numpy(built["x"]).cuda()
    cents = built["index"].centroids.contiguous()
    n, d = x.shape
    k = cents.shape[0]
    ms = time_ms(lambda: am.kmeans_assign_update_cuda(x, cents), n=5, warm=1)
    plain = time_ms(lambda: am.kmeans_assign_update_plain(x, cents), n=3,
                    warm=1)
    nbytes = (n * d + k * d) * 4 + n * 8 + (k * d + k) * 4
    rows.append(_row("kmeans_assign_update",
                     "src/repro_torch/csrc/kmeans_assign.cu",
                     "src/repro/kernels/kmeans_assign.py:108",
                     built["launches"]["kmeans_assign_update"],
                     kernel_errs["kmeans_assign_update"], ms, plain, nbytes,
                     2 * n * k * d,
                     "no single PyTorch call fuses the argmin with the "
                     "per-cluster sums and counts",
                     f"N={n} K={k} D={d} (enforce_size_bound)"))
    xs, cs = kmeans_inputs(5000, 8, 128, seed=21)
    small = time_ms(lambda: am.kmeans_assign_update_cuda(xs, cs), n=50)
    log(f"[times] K2 at the splitter's shape N=5000 K=8 D=128: "
        f"{small:.4f} ms")
    # K3: the splitter's M-step, K = 8 centroids of D = 128
    sums, counts, reseed = k3_inputs(8, 128, 2, seed=22)
    ms = time_ms(lambda: mm.kmeans_mstep_cuda(sums, counts, reseed), n=200)
    plain = time_ms(lambda: mm.kmeans_mstep_plain(sums, counts, reseed),
                    n=200)
    n_empty = int((counts <= 0).sum())
    nbytes = 8 * 128 * 4 * 2 + 8 * 4 + n_empty * 128 * 4
    rows.append(_row("kmeans_mstep", "src/repro_torch/csrc/kmeans_mstep.cu",
                     "src/repro/kernels/kmeans_mstep.py:90",
                     built["launches"]["kmeans_mstep"],
                     kernel_errs["kmeans_mstep"], ms, plain, nbytes, 8 * 128,
                     "no single PyTorch call divides by the counts and "
                     "reseeds the empty clusters by rank",
                     "K=8 D=128 (hierarchical splitter)"))
    return rows


def _row(name, source, replaces, launches, err, ms, plain_ms, nbytes, flops,
         library_note, shape) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": float(err), "ms": float(ms),
            "plain_ms": float(plain_ms), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "library_note": library_note,
            "shape": shape}


def main() -> int:
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    dev = phase_device()
    kernel_errs = phase_kernels()
    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    served = None
    try:
        built = phase_build(work)
        served = phase_serve(work, built)
        phase_parity(work, built, served)
        rows = phase_times(built, served, kernel_errs)
    finally:
        if served is not None:
            served["pipe"].close()
            served["pipe"].flash.release()
        shutil.rmtree(work, ignore_errors=True)
    log(f"[smoke] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(dev["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
