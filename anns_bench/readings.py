"""Read the numbers a cell's check computes, on many seeds in one process,
sound or with a fault of :mod:`faults` planted underneath.

    python3 anns_bench/readings.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--fault <name>] [--control]

From the root of a checkout, on a CUDA card.  Prints one JSON line a seed:
its numbers (those the cell's limits hold and those it logs), whether
they passed, the set-up seconds and, with ``--control``, the control's
numbers.  The limits in ``limits/<workload>.json`` are set between the
sound readings and those of the control or a fault (PERF.md); the
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from anns_bench import run as bench_run  # noqa: E402

# faults planted while an index is built: a kept index would carry them
BUILD_FAULTS = ("k23_init", "llsp_untrained")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    root = Path.cwd()
    cache = bench_run.setup(root)
    import torch

    from anns_bench import faults, harness

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = harness.load_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    keep = None if args.fault in BUILD_FAULTS else str(cache)
    for seed in args.seeds:
        plant = faults.planted(args.fault) if args.fault \
            else contextlib.nullcontext()
        with plant:
            res = harness.run_cell(
                cell, [], seed, args.seconds, False,
                control=cell.config["control"] if args.control else None,
                cache=keep)
        run = res["run"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "correct": res["correct"], "numbers": run.info["numbers"],
            "control": run.info.get("control"), "setup_s": run.setup_s,
            "index": run.info.get("index"), "check": res["check"]}),
            flush=True)
        del res, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
