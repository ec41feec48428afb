"""The process-group mesh (port of ``repro.launch.mesh``).

One process per mesh position; ``torch.distributed`` carries the
collectives.  A :class:`Mesh` names its axes, ``("data", "model")`` or
``("pod", "data", "model")``, lays the ranks out row-major over its shape,
and holds, for each axis, the subgroup of the ranks that differ only along
that axis.  A collective "over an axis" runs on that subgroup, whose group
ranks follow the axis index (the counterpart of ``jax.lax.axis_index``).

* :func:`init_mesh` starts the process group (with a short explicit
  timeout: a hung rank fails the run) and builds the mesh;
* :func:`make_host_mesh` and :func:`make_production_mesh` build the
  reference's shapes over a process group that is already started;
* :func:`dry_mesh` builds the production mesh at rank 0 over a fake
  process group on the ``meta`` device, whose collectives move nothing:
  the dry run's mesh (the reference forces 512 host devices for it);
* :func:`spawn` runs ``fn(mesh, *args)`` in one fresh process per rank
  (``torch.multiprocessing``, ``"spawn"`` mode, a file rendezvous in a
  fresh temporary directory), joins them under a timeout, and raises in
  the caller when any rank raised, died or did not finish.  ``fn`` must be
  importable by the children: a function at the top level of a module of
  this package.

NCCL takes one rank a card; gloo takes any number of ranks and CPU or
CUDA tensors (the collectives of ``distributed/collectives.py`` stage a
gloo group's CUDA tensors through host memory).

``Mesh.device_mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
over the same ranks, axes and subgroups: the mesh of the DTensors that
play the reference's global-view arrays (``distributed/sharding.py``
``distribute``), and of the ``local_map`` regions that play its
``shard_map``s.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike

DEFAULT_TIMEOUT_S = 120.0
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


class Mesh:
    """This rank's view of a mesh over the started process group.

    Every rank must construct it with the same shape and axes, in the same
    order relative to its other collectives: ``dist.new_group`` is
    collective, and each rank creates every axis's every subgroup.
    ``device`` defaults to this rank's current card."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: DeviceLike = None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} disagree")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                             f"{math.prod(shape)} ranks, the group has "
                             f"{world}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.rank = dist.get_rank()
        self.world = world
        self.device = _current_card(device)
        self.backend = dist.get_backend()
        coords = np.unravel_index(self.rank, shape)
        self.coords = {a: int(c) for a, c in zip(axes, coords)}
        self.groups = {}
        grid = np.arange(world).reshape(shape)
        for i, axis in enumerate(axes):
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
            for line in lines:                    # every rank, same order
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[axis] = group
            if dist.get_rank(self.groups[axis]) != self.coords[axis]:
                raise RuntimeError(f"group rank along {axis!r} is not the "
                                   f"axis index")
        from torch.distributed.device_mesh import DeviceMesh

        self.device_mesh = DeviceMesh.from_group(
            [self.groups[a] for a in axes],
            "cuda" if self.device.type == "cuda" else "cpu",
            mesh=torch.from_numpy(grid), mesh_dim_names=axes)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def host_staged(self) -> bool:
        """True when the collectives copy through host memory: a gloo
        group on CUDA tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords},"
                f" backend={self.backend}, device={self.device})")


def init_mesh(shape: Sequence[int], axes: Sequence[str], *, backend: str,
              init_method: str, device: DeviceLike = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Start the process group and build this rank's :class:`Mesh`.

    ``rank`` and ``world_size`` default to the ``RANK`` and ``WORLD_SIZE``
    environment variables (as ``torchrun`` sets them); the world size
    defaults to the mesh's size.  ``device`` defaults to the card of this
    rank (``cuda:rank % device_count``); NCCL needs one."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", math.prod(shape)))
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: a card was asked for and CUDA "
                               f"is absent")
        index = torch.device(device).index if device is not None else None
        device = torch.device(
            "cuda", rank % torch.cuda.device_count() if index is None
            else index)
        torch.cuda.set_device(device)
        from repro_torch.device import resolve_device

        resolve_device(device)                   # TF32 off, as elsewhere
    elif backend == "nccl":
        raise ValueError("NCCL runs on CUDA tensors only")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(shape, axes, device)


def _current_card(device: DeviceLike) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> Mesh:
    """A ``(data, model)`` mesh over the started group, as the reference
    shapes it: ``data`` capped at the world size, ``model`` the rest.
    ``device`` defaults to this rank's current card."""
    n = dist.get_world_size()
    data = min(data, n)
    return Mesh((data, max(1, n // data)), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The production mesh: ``(data=16, model=16)``, or ``(pod=2, data=16,
    model=16)``; raises unless the group has 256 (512) ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the group has "
                         f"{dist.get_world_size()}")
    return Mesh(shape, axes, device)


def dry_mesh(multi_pod: bool = False, *, shape: Sequence[int] = None,
             axes: Sequence[str] = None) -> Mesh:
    """The production mesh (or ``shape`` over ``axes``) at rank 0 of a
    fake process group of 256 (512) ranks, on the ``meta`` device: the
    collectives of a program over it complete at once and move nothing,
    and its tensors hold no memory.  Starts the fake group unless one of
    that size is running."""
    if shape is None:
        shape, axes = PRODUCTION_SHAPES[multi_pod]
    world = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("dry_mesh needs the fake process group; a "
                               f"{dist.get_backend()} group is running")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return Mesh(shape, axes, "meta")


# --------------------------------------------------------------------------
# one process per rank
# --------------------------------------------------------------------------
class RankFailed(RuntimeError):
    """A rank raised, died or did not finish; the message holds its
    traceback or its exit code."""


def _rank_main(rank, world, shape, axes, backend, device, init_method,
               timeout_s, fn, args, out):
    """A child's body: report ``fn``'s result or exception on ``out`` and
    exit normally, so that a non-zero exit code means the process died."""
    # the ranks share the host's cores: a pool each of all of them would
    # oversubscribe it many times over
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        mesh = init_mesh(shape, axes, backend=backend,
                         init_method=init_method, device=device, rank=rank,
                         world_size=world, timeout_s=timeout_s)
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        out.put((rank, False, _pickled(e), traceback.format_exc()))
        return
    try:
        out.put((rank, True, fn(mesh, *args), ""))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        out.put((rank, False, _pickled(e), traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _pickled(e: BaseException) -> Optional[bytes]:
    try:
        return pickle.dumps(e)
    except Exception:  # noqa: BLE001 — the traceback text still goes
        return None


def _unpickled(val: Optional[bytes]) -> Optional[BaseException]:
    try:
        return pickle.loads(val) if val is not None else None
    except Exception:  # noqa: BLE001 — the traceback text still goes
        return None


def spawn(fn: Callable, shape: Sequence[int], axes: Sequence[str], *,
          backend: str, device: DeviceLike = None, args: tuple = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh, one
    process each, and return the ranks' results in rank order.

    ``device`` defaults to each rank's card (``cuda:rank % device_count``,
    as :func:`init_mesh` picks it); pass ``"cpu"`` for CPU ranks.

    Raises :class:`RankFailed` (from the rank's own exception, where it
    pickles) as soon as one rank raises or dies, and when the ranks have
    not all finished ``timeout_s`` seconds after the start; every child is
    stopped before it returns or raises."""
    world = math.prod(shape)
    ctx = torch.multiprocessing.get_context("spawn")
    rdv = tempfile.mkdtemp(prefix="mesh-rdv-")
    init_method = f"file://{os.path.join(rdv, 'rdv')}"
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, tuple(shape), tuple(axes), backend,
                               device, init_method, timeout_s, fn, args, out))
             for r in range(world)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - set(results))
                raise RankFailed(f"ranks {late} did not finish in "
                                 f"{timeout_s} s")
            try:
                rank, ok, val, tb = out.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RankFailed(f"rank {dead[0][0]} died with exit "
                                     f"code {dead[0][1]}") from None
                continue
            if not ok:
                raise RankFailed(f"rank {rank} raised:\n{tb}") \
                    from _unpickled(val)
            results[rank] = val
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10.0)
        out.close()
        shutil.rmtree(rdv, ignore_errors=True)
