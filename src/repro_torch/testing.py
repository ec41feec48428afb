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
  seconds.
"""
from __future__ import annotations

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
