"""Test helpers of the benchmark: the repository's root and ``src/`` on the
path, and :func:`tiny_cell`, a cell of ``BENCHMARK.json`` cut to a size
that the CPU runs in seconds (the program's plain versions)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(workload: str, n: int = 3000):
    """``workload`` with its widths and traffic shape kept, its scale cut:
    ``n`` corpus rows in 4 modes, a pool of 1024, LLSP levels up to 16,
    4 callers of 256; its limits but the one tied to the data set's
    scale."""
    from anns_bench import harness

    cell = harness.load_cell(bench(), workload)
    c = cell.config
    c["dataset"].update(n=n, pool=1024)
    c["build"]["coarse_per_task"] = 2000
    c["llsp"].update(levels=[4, 8, 16], train_queries=128)
    c["serve"]["nprobe_max"] = 16
    c["assumed"]["generator"]["modes"] = 4
    # the distortion limit is a mean squared distance of the cell's own
    # data set; a data set cut to this size has another scale
    cell.limits.pop("distortion", None)
    if cell.traffic["kind"] != "build":
        cell.traffic.update(callers=4, block=256, max_batch=256,
                            sq_depth=1024, warm_blocks=2, warm_sizes=[256])
    return cell
