"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell, rank 0's program runs
on the ``meta`` device over a fake process group of 256 (``single``) or
512 (``multi``) ranks (``launch/mesh.py`` ``dry_mesh``): the cell's
arguments become DTensors of their global shapes placed by the cell's
specs, the step runs once (forward and backward for a train cell),
DTensor inserts the collectives, and ``launch/op_analysis.py`` counts the
rank's local ops: flops, bytes, collective bytes by kind and the peak of
live bytes.  Nothing is allocated and no card is needed.

Results go to one JSON per cell under ``results/dryrun_torch/`` with the
reference's record keys (``hlo_chars`` becomes ``n_local_ops``), so the
sweep is resumable: a cell whose JSON says ``ok`` is not run again unless
``--force``.  The roofline terms use the NVIDIA H100 80GB HBM3's figures
at 700 W (989e12 bf16 dense flop/s, 3.35e12 B/s HBM, 450e9 B/s NVLink
each way); ``fits`` compares the peak with the card's 80 GB.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3_12b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force] [--variant opt]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import all_archs, get

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# NVIDIA H100 80GB HBM3 (SXM, 700 W)
PEAK_FLOPS = 989e12        # bf16 dense flop/s
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # NVLink bytes/s each way
HBM_BYTES = 80e9


def _tag(arch_name: str, shape_name: str, mesh_kind: str,
         variant: str) -> str:
    return f"{arch_name}.{shape_name}.{mesh_kind}" + (
        "" if variant == "base" else f".{variant}")


def measure_cell(arch, shape_name: str, mesh, variant: str = "base"):
    """Build the cell of ``arch`` (a registry name or an ``ArchDef``) on
    ``mesh``, run it once on DTensors under an
    :class:`~repro_torch.launch.op_analysis.OpCounter`; returns (cell,
    totals, build seconds, run seconds)."""
    import torch

    from repro_torch.distributed.sharding import distribute, \
        implicit_replication, redistribute
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.op_analysis import OpCounter

    t0 = time.perf_counter()
    cell = build_cell(get(arch) if isinstance(arch, str) else arch,
                      shape_name, mesh, variant=variant)
    args = tuple(distribute(a, s, mesh)
                 for a, s in zip(cell.abstract_args, cell.in_specs))
    t_build = time.perf_counter() - t0
    counter = OpCounter(args)
    with counter, implicit_replication(), torch.no_grad():
        out = cell.fn(*args)
        if cell.out_specs is not None:
            out = _to_out_specs(out, cell.out_specs, mesh, redistribute)
        del out
    t_run = time.perf_counter() - t0 - t_build
    return cell, counter.totals, t_build, t_run


def _to_out_specs(out, specs, mesh, redistribute):
    if isinstance(out, tuple) and isinstance(specs, tuple):
        return tuple(o if s is None else redistribute(o, s, mesh)
                     for o, s in zip(out, specs))
    return redistribute(out, specs, mesh)


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             out_dir: str, force: bool = False,
             variant: str = "base") -> dict:
    from repro_torch.launch.mesh import dry_mesh

    os.makedirs(out_dir, exist_ok=True)
    tag = _tag(arch_name, shape_name, mesh_kind, variant)
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            cached = json.load(f)
        if cached.get("ok"):        # failed cells re-run on the next sweep
            return cached

    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
           "variant": variant, "ok": False}
    t0 = time.perf_counter()
    try:
        mesh = dry_mesh(multi_pod=(mesh_kind == "multi"))
        n_chips = mesh.world
        cell, tot, t_build, t_run = measure_cell(arch_name, shape_name,
                                                 mesh, variant)
        compute_s = tot.flops / PEAK_FLOPS
        memory_s = tot.bytes / HBM_BW
        coll_s = tot.coll_total / LINK_BW
        mem_rec = {
            "argument_size_in_bytes": tot.arg_bytes,
            "temp_size_in_bytes": tot.peak_bytes - tot.arg_bytes,
            "peak_size_in_bytes": tot.peak_bytes,
        }
        rec.update({
            "ok": True,
            "n_chips": n_chips,
            "flops": tot.flops,
            "bytes_accessed": tot.bytes,
            # the DTensor-level count at global shapes (FlopCounterMode's)
            "raw_cost_analysis": {"flops": tot.global_flops, "bytes": None},
            "n_while_loops": 0,
            "collectives": {"bytes": tot.coll, "ops": tot.coll_ops,
                            "total": tot.coll_total},
            "memory_analysis": mem_rec,
            "bytes_per_device": dict(mem_rec),
            "fits": tot.peak_bytes <= HBM_BYTES,
            "roofline": {
                "compute_s": compute_s,
                "memory_s": memory_s,
                "collective_s": coll_s,
                "dominant": max(
                    [("compute", compute_s), ("memory", memory_s),
                     ("collective", coll_s)], key=lambda kv: kv[1])[0],
            },
            "model_flops": cell.model_flops,
            "useful_ratio": (cell.model_flops / (tot.flops * n_chips)
                             if tot.flops else None),
            "note": cell.note,
            "n_local_ops": tot.n_local_ops,
            "seconds": {"lower": t_build, "compile": t_run},
            "device": "NVIDIA H100 80GB HBM3, 700 W (constants)",
        })
    except Exception as e:  # noqa: BLE001 — recorded, the sweep continues
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["seconds"] = {"total": time.perf_counter() - t0}
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK " if rec["ok"] else "FAIL"
    print(f"[{status}] {tag}  "
          + (f"flops={rec['flops']:.3g} coll={rec['collectives']['total']:.3g}"
             f" peak={rec['memory_analysis']['peak_size_in_bytes']:.3g}"
             f" dom={rec['roofline']['dominant']}"
             f" run={rec['seconds']['compile']:.1f}s"
             if rec["ok"] else rec.get("error", "")), flush=True)
    return rec


def cell_list(arch: str = None, shape: str = None, mesh: str = "single",
              all_: bool = False, out_dir: str = RESULTS_DIR) -> list:
    """The (arch, shape, mesh) runs of a sweep; with ``all_`` also writes
    the skip records (``ok`` None, the reason under ``skipped``)."""
    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    cells = []
    if all_:
        for a in all_archs():
            for s in a.shapes:
                for m in meshes:
                    cells.append((a.name, s, m))
            for sname, reason in a.skip_shapes:
                for m in meshes:
                    os.makedirs(out_dir, exist_ok=True)
                    path = os.path.join(out_dir, f"{a.name}.{sname}.{m}.json")
                    with open(path, "w") as f:
                        json.dump({"arch": a.name, "shape": sname, "mesh": m,
                                   "ok": None, "skipped": reason}, f,
                                  indent=1)
    else:
        if not (arch and shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(arch, shape, m) for m in meshes]
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    n_ok = n_fail = 0
    for arch_name, shape, m in cell_list(args.arch, args.shape, args.mesh,
                                         args.all, args.out):
        rec = run_cell(arch_name, shape, m, args.out, force=args.force,
                       variant=args.variant)
        if rec.get("ok"):
            n_ok += 1
        elif rec.get("ok") is False:
            n_fail += 1
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
