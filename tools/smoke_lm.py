#!/usr/bin/env python3
"""``chip_smoke.py``'s LM and GNN phases alone on one card.

    python3 tools/smoke_lm.py [--only serve,train,gnn,parity,cli,mesh] \
        [--archs phi4_mini,qwen2_moe]

Runs phase 17 (the five LMs served at their published widths, phi4-mini
and GraphCast trained, card-against-CPU parity, the training CLI's drills,
the deterministic combines) and phase 15 (g) and (h) (expert parallelism
and GraphCast's row-sharded forward over four gloo processes sharing the
card), printing the smoke's lines.  ``--only`` runs the named parts,
``--archs`` serves only the named LMs.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

PARTS = ("serve", "train", "gnn", "parity", "cli", "mesh")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(PARTS))
    ap.add_argument("--archs", default="")
    args = ap.parse_args(argv)
    parts = args.only.split(",")
    if args.archs:
        keep = args.archs.split(",")
        cs.LM_SERVE = tuple(a for a in cs.LM_SERVE if a[0] in keep)
    dev = cs.phase_device()
    card = cs.CARD[0] = dev["card"]
    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    try:
        if set(PARTS[:-1]) <= set(parts):
            cs.phase_lm(work, card)
        else:
            for name, batch, layers in cs.LM_SERVE:
                if "serve" in parts:
                    cs.lm_serve(name, batch, layers, card)
            if "train" in parts:
                cs.lm_train(card)
            if "gnn" in parts:
                cs.gnn_train(card)
            if "parity" in parts:
                cs.lm_gnn_parity()
            if "cli" in parts:
                cs.lm_cli(work, card)
        if "mesh" in parts:
            cs.mesh_lm_gnn(work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(f"[smoke-lm] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
