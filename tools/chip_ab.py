#!/usr/bin/env python3
"""Two checkouts of the repository measured side by side on one card.

    python3 tools/chip_ab.py --tree OLD --tree NEW --tree NEW --tree OLD \
        [--rate 869.3] [--out FILE]

Each ``--tree`` is the root of a checkout (this one, or an unpacked
``git archive`` of another commit).  The trees run one after another, each
in a process of its own that imports that tree's ``repro_torch`` and
``chip_smoke.py`` and builds that tree's kernels.  The timers are this
script's, so every tree is read with the same yardstick:

- K1 (``ivf_scan_q8_topk``) alone on a prebuilt plan and through its
  wrapper, and B2 (``ivf_scan_topk``) the same, on one synthetic batch made
  from a seed (B 32, P 16, 512 packed rows of L 128 and D 128, k2 24: the
  shape of chip_smoke's phase 6); each timed two ways: CUDA events around
  n launches as chip_smoke's ``time_ms`` times them ("events", the host's
  enqueue time included when it is the longer), and the same launches
  queued behind a sleep kernel ("queued", the card's time alone);
- the 1M build of the tree's own phase 3 and its ``index_content_hash``;
- run (a) of the tree's phase 11 (engine, quality stack on, one 6 s
  open-loop trace) at the fixed offered rate ``--rate`` in q/s, in place of
  a quarter of phase 4's QPS, and the 256 recall probes after it.

Prints one JSON object a tree, on a line starting ``AB``, and writes them
all to ``--out`` as a JSON list.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SLEEP_CYCLES_PER_S = 1.98e9      # torch.cuda._sleep's unit: SM clock cycles
                                 # (the H100 SXM's 1,980 MHz boost clock)


def time_two_ways(fn, n: int, warm: int = 3) -> dict:
    """Device ms a call of ``fn``: CUDA events around n calls, first as they
    are issued, then with the n calls queued behind a sleep kernel that
    holds the stream for about twice the host's time to issue them."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    host_s = (time.perf_counter() - t0) / max(warm, 1)
    out = {}
    for how in ("events", "queued"):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if how == "queued":
            torch.cuda._sleep(int(min(2 * n * host_s, 1.0)
                                  * SLEEP_CYCLES_PER_S))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        out[how] = a.elapsed_time(b) / n
    return out


def kernel_times(cs) -> dict:
    from repro_torch.kernels import ivf_scan as scan
    from repro_torch.kernels import ivf_scan_q8 as q8m
    from repro_torch.kernels.ivf_scan import plan_tile_probes

    k2 = 24
    q8, scale, norm2, cents, ids, cids, mask, q = cs.q8_inputs(
        512, 128, 128, 32, 16, seed=1, dead=0.05, masked=0.2)
    tc1, qs1 = plan_tile_probes(cids, mask, 1, q8.shape[0])
    qs1 = qs1.reshape(cids.shape)
    k1 = {"alone": time_two_ways(lambda: q8m.ivf_scan_q8_topk_planned(
              q8, scale, norm2, cents, ids, tc1, qs1, q, k2=k2), n=200),
          "wrapper": time_two_ways(lambda: q8m.ivf_scan_q8_topk_cuda(
              q8, scale, norm2, cents, ids, cids, mask, q, k2=k2), n=200)}
    post, pids, cids, mask, q = cs.f32_inputs(512, 128, 128, 32, 16, seed=15,
                                              dead=0.05, masked=0.2)
    pc, pm, pq = scan._pad_tile(cids, mask, q, scan.BQ)
    tc, qs = plan_tile_probes(pc, pm, scan.BQ, post.shape[0])
    b2 = {"alone": time_two_ways(lambda: scan.ivf_scan_topk_planned(
              post, pids, tc, qs, pq, k2=k2), n=200),
          "wrapper": time_two_ways(lambda: scan.ivf_scan_topk_cuda(
              post, pids, cids, mask, q, k2=k2), n=200)}
    return {"ivf_scan_q8_topk": k1, "ivf_scan_topk": b2}


def run_one(tree: str, rate: float) -> dict:
    tree = os.path.abspath(tree)
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
    out = {"tree": tree, "card": card, "kernels": kernel_times(cs)}
    work = tempfile.mkdtemp(prefix="chip_ab_")
    built = cs.phase_build(work)
    out["build_s"] = built["build_s"]
    out["index_content_hash"] = index_content_hash(built["index"])[:16]
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
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print("AB " + json.dumps(run_one(a.one, a.rate)), flush=True)
        return 0
    if not a.tree:
        ap.error("give at least one --tree")
    results = []
    for tree in a.tree:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree, "--rate", str(a.rate)],
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
