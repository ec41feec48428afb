"""Run one cell of the benchmark once and print its result.

    python3 anns_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``anns_bench/``
and the program under ``src/``.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and, traced, ``breakdown``), then ``check``: each number compared beside
its limit, which also closes standard error.  Without a CUDA card, with
fewer cards than the cell asks for, without the program, or with ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` loaded once the window
has closed, it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def setup(root: Path) -> Path:
    """The process's environment for a run from checkout ``root``; returns
    the checkout's cache directory."""
    # caches live inside the checkout, at fixed paths
    cache = root / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    # one serving process with few threads: the CPU thread pools of torch
    # and BLAS stay at one thread, so they do not compete for the host's
    # cores with the engine's poller, gather and re-rank threads (with
    # eight of them the tiered cell's q/s spread 22% between runs)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch

    torch.set_num_threads(1)
    return cache


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also judge the cell's control (the reference in a "
                         "lower precision) on the same sample and log its "
                         "numbers; the benchmark's own runs do not")
    args = ap.parse_args(argv)

    root = Path.cwd()
    cache = setup(root)

    import torch

    from anns_bench import harness, trace

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = harness.load_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    metrics = harness.cell_metrics(bench, args.workload, bool(args.trace))
    res = harness.run_cell(cell, metrics, args.seed, args.seconds,
                           bool(args.trace),
                           control=cell.config["control"] if args.control
                           else None,
                           extra_metrics=harness.cell_metrics(
                               bench, args.workload, not args.trace),
                           cache=str(cache))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may not load JAX or the "
              "JAX package", file=sys.stderr)
        return 4
    run = res["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res["peak"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        tr = run.trace
        if tr is None:
            print("the profiler recorded no device activity", file=sys.stderr)
            return 5
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_by_stage(
                                 trace.host_stages(run))}
    line["check"] = res["check"]
    info = {"card": power_limit(), "setup_s": run.setup_s, **run.info}
    print(f"[run] {args.workload} seed {args.seed}: {json.dumps(info)}",
          file=sys.stderr)
    for name, (value, limit) in res["check"].items():
        print(f"[check] {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
