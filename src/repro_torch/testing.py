"""Rank programs that check the mesh launcher itself, for
:func:`repro_torch.launch.mesh_jobs.run` (pass the function as a job's
``kind``).  No deployment runs them.

* :func:`layout`: this rank's coordinates and subgroups, every
  ``anns_specs`` entry cut with ``shard_local`` and rebuilt with
  ``gather_axes``, the shape of ``make_host_mesh(2, 4)`` and
  ``make_production_mesh``'s refusal;
* :func:`devices`: the device of the spawned mesh and of a mesh built
  without one;
* :func:`fail`: rank ``rank`` raises, the others wait in a barrier;
* :func:`lock`: the kernel library's build lock held for ``hold_s``
  seconds;
* :func:`mesh_step_check`: a cell's train step on the mesh against the
  one-process step on the same arrays, compared on the rank.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import anns_specs, gather_axes, \
    shard_local
from repro_torch.kernels.cuda_lib import build_lock
from repro_torch.launch.mesh import Mesh, make_host_mesh, \
    make_production_mesh


def layout(mesh: Mesh, job: dict) -> dict:
    rebuilt = {}
    for name, spec in anns_specs(mesh).items():
        local = torch.from_numpy(np.ascontiguousarray(
            shard_local(job["arrays"][name], spec, mesh)))
        rebuilt[name] = (gather_axes(local, mesh, spec[0]) if spec
                         else local).numpy()
    host = make_host_mesh(2, 4, device=mesh.device)
    try:
        make_production_mesh(device=mesh.device)
        production = None
    except ValueError as e:
        production = str(e)
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "sizes": dict(mesh.shape), "host_mesh": dict(host.shape),
            "production_error": production,
            "indices": {a: mesh.index(a) for a in mesh.axis_names},
            "groups": {a: dist.get_process_group_ranks(mesh.group(a))
                       for a in mesh.axis_names},
            "rebuilt": rebuilt}


def devices(mesh: Mesh, job: dict) -> list:
    return [str(mesh.device),
            str(Mesh(tuple(mesh.shape.values()), mesh.axis_names).device)]


def fail(mesh: Mesh, job: dict) -> None:
    if mesh.rank == job["rank"]:
        raise ValueError(job.get("msg", "rank failed on purpose"))
    dist.barrier()                    # never completes: one rank is gone


def lock(mesh: Mesh, job: dict) -> tuple:
    """Hold the build lock of ``job["dir"]`` for ``hold_s`` seconds after
    every rank reached it; returns the (enter, leave) wall times."""
    dist.barrier()
    with build_lock(Path(job["dir"])):
        enter = time.time()
        time.sleep(job.get("hold_s", 0.3))
        leave = time.time()
    return enter, leave


def mesh_step_check(mesh: Mesh, job: dict) -> dict:
    """One train step of ``launch/cells.py``'s cell ``arch`` at its shape
    named ``cell`` on this mesh against the one-process step, compared on
    the rank (nothing large leaves it).  The global parameters and batch
    are ``torch.load``'ed from ``<work>/<args>.pt``, the AdamW state is
    fresh; the cell's step runs ``steps`` times on DTensors placed by its
    specs (each timed, each on the state the last returned), then the
    family's one-process ``make_train_step`` once on the same arrays.
    Returns the first mesh step's loss and the one-process loss, the
    largest parameter difference past ``adamw_step_gap``'s allowance, the
    moments' largest difference over their largest, ms a step both ways
    and the peak memory of each."""
    from repro_torch.distributed.collectives import tree_flatten, tree_map
    from repro_torch.distributed.sharding import distribute, full, \
        implicit_replication
    from repro_torch.launch.cells import build_cell
    from repro_torch.optim import adamw

    arch = job["arch"]
    c = build_cell(arch, job["cell"], mesh)
    params, batch = torch.load(os.path.join(job["work"],
                                            f"{job['args']}.pt"),
                               weights_only=False)
    params, batch = tree_map(lambda t: t.to(mesh.device), (params, batch))
    glob = (params, adamw.init(params), batch)
    args = tuple(distribute(a, sp, mesh) for a, sp in zip(glob, c.in_specs))
    cuda = mesh.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(mesh.device)) if cuda \
        else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    ms, first = [], None
    with implicit_replication():
        for _ in range(job.get("steps", 1)):
            sync()
            t0 = time.perf_counter()
            out = c.fn(*args)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = full(out)
            args = tuple(out[j] if j in c.donate else a
                         for j, a in enumerate(args))
    del args, out
    peak = torch.cuda.max_memory_allocated(mesh.device) if cuda else 0
    if arch.family == "recsys":
        from repro_torch.models.recsys.models import make_train_step
        cfg = adamw.AdamWConfig(weight_decay=0.0)
    elif arch.family == "lm":
        from repro_torch.models.lm.transformer import make_train_step
        cfg = adamw.AdamWConfig()
    else:
        from repro_torch.models.gnn.graphcast import make_train_step
        cfg = adamw.AdamWConfig()
    step = make_train_step(arch.config)
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    sync()
    t0 = time.perf_counter()
    want = step(*glob)
    sync()
    one_ms = (time.perf_counter() - t0) * 1e3
    one_peak = torch.cuda.max_memory_allocated(mesh.device) if cuda else 0
    flat = lambda tree: tree_flatten(tree)[0]
    u = lambda m, v: (m.double() / (1 - cfg.b1)) / (
        torch.sqrt(v.double() / (1 - cfg.b2)) + cfg.eps)
    excess = mom = 0.0
    for p, q, gm, gv, wm, wv in zip(flat(first[0]), flat(want[0]),
                                    flat(first[1].mu), flat(first[1].nu),
                                    flat(want[1].mu), flat(want[1].nu)):
        gap = cfg.lr * (u(gm, gv) - u(wm, wv)).abs()
        excess = max(excess, float(((p.double() - q.double()).abs()
                                    - gap).max()))
        for a, b in ((gm, wm), (gv, wv)):
            top = float(b.abs().max())
            if top > 0:
                mom = max(mom, float((a - b).abs().max()) / top)
    return {"rank": mesh.rank, "loss": float(first[2]["loss"]),
            "one_loss": float(want[2]["loss"]), "param_excess": excess,
            "moment_gap": mom, "ms": ms, "one_ms": one_ms, "peak": peak,
            "one_peak": one_peak}
