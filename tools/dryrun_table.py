#!/usr/bin/env python3
"""The dry run's per-cell records as one markdown table.

    python3 tools/dryrun_table.py [results/dryrun_torch]

One row per (arch, shape); for each of the single and multi meshes the
per-device flops, bytes accessed, collective bytes by kind (all-reduce /
all-gather / reduce-scatter / all-to-all, the reference's traffic
factors), the peak of live bytes, the dominant roofline term and whether
the peak fits the card's 80 GB.  Skipped shapes are listed with their
reason, failed cells with their error.
"""
from __future__ import annotations

import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


def g(x: float) -> str:
    return f"{x:.3g}"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else os.path.join(ROOT, "results", "dryrun_torch")
    recs = {}
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        recs.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    print("| cell | flops s / m | bytes s / m | coll AR/AG/RS/A2A s | "
          "coll AR/AG/RS/A2A m | peak GB s / m | dominant s / m | fits "
          "s / m |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    skipped, failed = [], []
    for (arch, shape), by in recs.items():
        if any(r.get("ok") is None for r in by.values()):
            skipped.append(f"{arch}.{shape}: {next(iter(by.values()))['skipped']}")
            continue
        bad = [f"{arch}.{shape}.{m}: {r.get('error')}" for m, r in by.items()
               if not r.get("ok")]
        if bad:
            failed += bad
            continue
        s, m = by.get("single"), by.get("multi")
        pick = lambda f: " / ".join(f(r) if r else "-" for r in (s, m))
        coll = lambda r: "/".join(g(r["collectives"]["bytes"][k])
                                  for k in KINDS) if r else "-"
        print(f"| {arch}.{shape} | {pick(lambda r: g(r['flops']))} | "
              f"{pick(lambda r: g(r['bytes_accessed']))} | {coll(s)} | "
              f"{coll(m)} | "
              f"{pick(lambda r: g(r['memory_analysis']['peak_size_in_bytes'] / 1e9))}"
              f" | {pick(lambda r: r['roofline']['dominant'])} | "
              f"{pick(lambda r: 'yes' if r['fits'] else 'no')} |")
    for line in skipped:
        print(f"skipped: {line}")
    for line in failed:
        print(f"failed: {line}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
