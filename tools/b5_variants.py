#!/usr/bin/env python3
"""B5 (``pairwise_l2``) in both of its variants over a grid of shapes on
one card, to place the narrow/wide threshold of
``repro_torch.kernels.pairwise_l2.NARROW_MAX_M``.

    python3 tools/b5_variants.py [--d 128] [--out FILE]

For every N of ``--n`` and M of ``--m`` (D fixed) it times the narrow
variant (where b fits its shared memory) and the wide one through
``pairwise_l2_cuda(a, b, variant=...)`` with ``time_two_ways`` of
``chip_smoke.py`` (CUDA events around launches as issued, and the same
launches queued behind a sleep kernel: the card's time alone), on standard
normal inputs made from a seed.  Prints one line a shape and, with
``--out``, writes the rows as a JSON list.  ``--split`` adds each kernel's
device time by torch.profiler (the wide variant's prep and product
kernels), ``--k2`` the device time of K2's ``assign_kernel`` (the same
product with the argmin folded in) at each shape.  ``--host`` first splits the
wrapper's host time at the unfused build's most launched shape (97 x 2 x
128) into its steps, each timed alone on the host's clock over many calls.
Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def host_split(n: int = 97, m: int = 2, d: int = 128,
               reps: int = 2000) -> dict:
    """Host microseconds a call of each step of ``pairwise_l2_cuda`` at
    (n, m, d), and of the whole wrapper, by the host's clock (the card
    runs the launches meanwhile; the split is of the host's issue time)."""
    import time

    import torch

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import pairwise_l2 as pw

    x = torch.randn(n, d, device="cuda")
    c = torch.randn(m, d, device="cuda")
    out = torch.empty((n, m), device="cuda")
    dev = x.device
    lib = cuda_lib.library()
    stream = cuda_lib.stream_handle(dev)
    steps = {
        "wrapper": lambda: pw.pairwise_l2_cuda(x, c),
        "torch.empty": lambda: torch.empty((n, m), dtype=torch.float32,
                                           device=dev),
        "new_empty": lambda: x.new_empty((n, m)),
        "stream_handle": lambda: cuda_lib.stream_handle(dev),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "library()": cuda_lib.library,
        "variant": lambda: pw.pairwise_l2_variant(n, m, d),
        "data_ptr x3": lambda: (x.data_ptr(), c.data_ptr(), out.data_ptr()),
        "ctypes launch": lambda: lib.pairwise_l2_launch(
            x.data_ptr(), c.data_ptr(), 0, out.data_ptr(), n, m, d, m, 0,
            stream),
        "LAUNCHES.add": lambda: cuda_lib.LAUNCHES.add("pairwise_l2"),
    }
    res = {}
    for name, fn in steps.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        res[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return res


# each variant's kernels, by a part of the name torch.profiler shows
PARTS = {"narrow": ("pw_narrow_kernel",),
         "wide": ("pw_prep_kernel", "pw_wide_kernel")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[97, 1000, 5000, 16384])
    ap.add_argument("--m", type=int, nargs="+",
                    default=[1, 2, 4, 8, 12, 16, 24, 32, 48, 64])
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--k2", action="store_true",
                    help="also K2's product kernel (its E-step with the "
                         "argmin folded in) at each shape")
    ap.add_argument("--split", action="store_true",
                    help="also each kernel's device ms (torch.profiler)")
    a = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs      # puts src/ on sys.path
    from repro_torch.kernels import pairwise_l2 as pw

    if not torch.cuda.is_available():
        raise SystemExit("b5_variants: no CUDA device")
    print(cs.phase_device()["card"], flush=True)
    if a.host:
        print("host us a call: " + json.dumps(host_split()), flush=True)
    rng = np.random.default_rng(a.seed)
    rows = []
    for n in a.n:
        for m in a.m:
            x = torch.from_numpy(rng.standard_normal((n, a.d), np.float32))
            c = torch.from_numpy(rng.standard_normal((m, a.d), np.float32))
            x, c = x.cuda(), c.cuda()
            row = {"n": n, "m": m, "d": a.d,
                   "picked": pw.pairwise_l2_variant(n, m, a.d),
                   "bound_ms": cs.b5_bound_ms(n, m, a.d)}
            for v in ("narrow", "wide"):
                if v == "narrow" and pw.narrow_rows(m, a.d) < 1:
                    continue
                t = cs.time_two_ways(
                    lambda: pw.pairwise_l2_cuda(x, c, variant=v), n=50)
                row[v] = {"events_ms": t["events"], "device_ms": t["queued"]}
                if a.split:
                    row[v]["split_ms"] = cs.kernel_split_ms(
                        lambda: pw.pairwise_l2_cuda(x, c, variant=v),
                        PARTS[v], n=10)
            if a.k2:
                from repro_torch.kernels import kmeans_assign as am

                row["k2_assign_kernel_ms"] = cs.kernel_split_ms(
                    lambda: am.kmeans_assign_update_cuda(x, c),
                    ("assign_kernel",), n=10)["assign_kernel"]
            print(json.dumps(row), flush=True)
            rows.append(row)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
