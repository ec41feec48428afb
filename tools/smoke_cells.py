#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 18 alone on one card.

    python3 tools/smoke_cells.py [--mesh single|multi|both]
        [--only train,examples,dryrun]

Runs (a) the mesh train steps (MIND at batch 65,536, one qwen2-moe layer,
``kmeans_sharded_step`` on DTensors) at one NCCL rank, (c) both example
twins on the card and (b) the dry-run sweep in child processes on the
host, printing the smoke's lines.  ``--mesh`` picks the sweep's meshes;
``--only`` runs the named parts.
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

PARTS = ("train", "examples", "dryrun")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=cs.DRY_MESH,
                    choices=["single", "multi", "both"])
    ap.add_argument("--only", default=",".join(PARTS))
    args = ap.parse_args(argv)
    parts = args.only.split(",")
    cs.DRY_MESH = args.mesh
    dev = cs.phase_device()
    card = cs.CARD[0] = dev["card"]
    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    try:
        if "train" in parts:
            cs.mesh_train_steps(work, card)
        if "examples" in parts:
            cs.examples_on_card(card)
        if "dryrun" in parts:
            cs.dryrun_sweep(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(f"[smoke_cells] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
