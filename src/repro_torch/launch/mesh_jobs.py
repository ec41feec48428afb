"""Rank programs for :func:`repro_torch.launch.mesh.spawn`.

``spawn(run, shape, axes, args=(jobs,))`` runs :func:`run` on every rank:
it runs each job of the list in turn, each on a mesh of its own ``shape``
and ``axes`` over the same process group (so one spawn can serve on (2, 2),
then on (1, 4), then take a Lloyd step on (4, 1)), and returns one result
a job.  Arrays reach the ranks as ``.npy`` files under the job's ``work``
directory, which each rank maps and cuts to its own block
(``distributed/sharding.py`` ``shard_local``), or inside the job dict when
they are small; results come back as numpy arrays.

Jobs (``kind``):

* ``serve``: the sharded engine (``engine`` "f32": ``make_sharded_serve``,
  "q8": ``make_sharded_serve_quantized``) over ``queries.npy`` and
  ``topk.npy`` (or the files that ``queries`` and ``topk`` name) in global
  batches of ``batch``, each rank on its cluster stripe and query block;
  the time a batch covers the engine calls alone; after that window every
  rank gathers the outputs and rank 0 returns them, with an estimate of
  the engine's collectives' share of a batch (its all-gathers replayed
  alone at the same shapes and count);
* ``kmeans``: ``steps`` timed ``kmeans_sharded_step`` calls (after one
  untimed, unless ``warm`` is False) on the rank's rows of ``x.npy`` from
  ``cents.npy``, then the counts from ``kmeans_sharded_sums``;
* ``collectives``: ``compressed_psum_tree`` of a tree held alike on every
  rank, ``bucketed_psum`` of the tree times (rank + 1), and
  ``compressed_psum`` twice with error feedback;
* ``recsys``: the row-sharded embedding tables.  With ``embedding``,
  ``embedding_lookup_sharded`` and ``embedding_bag_sharded`` (weighted by
  ``weights.npy`` where it exists) over the rank's rows of ``table.npy``
  and its block of ``ids.npy``; for each name of ``archs``,
  ``forward(mesh=...)`` of that registry arch at ``rows`` table rows,
  from the parameters checkpointed under ``<arch>_params`` (the port's
  ``ckpt.save``) and the batch in ``<arch>_batch.npz``.  Rank 0 writes the
  gathered outputs to ``lookup.npy``, ``bag.npy`` and
  ``<arch>_logits.npy`` in ``work``.

A job's ``kind`` may also be a function ``f(mesh, job)`` at the top level of
a module of this package (``repro_torch.testing`` holds the ones that
check the launcher itself).

Every result carries the rank's kernel launch counts of the job
(``cuda_lib.LAUNCHES``, reset when the job starts its measured run).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.cuda_lib import LAUNCHES

from .mesh import Mesh


def run(mesh: Mesh, jobs: list) -> list:
    """Run ``jobs`` in order on this rank; one result each."""
    out = []
    for job in jobs:
        m = mesh
        if "shape" in job:
            m = Mesh(job["shape"], job.get("axes", ("data", "model")),
                     mesh.device)
        kind = job["kind"]
        out.append((kind if callable(kind) else _KINDS[kind])(m, job))
        if m.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _block(work: str, name: str, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``<work>/<name>.npy`` on the mesh's device,
    read through a memory map (only the block is read)."""
    from repro_torch.distributed.sharding import shard_local

    arr = np.load(os.path.join(work, f"{name}.npy"), mmap_mode="r")
    blk = np.array(shard_local(arr, spec, mesh))        # owned, writable
    return torch.from_numpy(blk).to(mesh.device)


# --------------------------------------------------------------------------
# LLSP params as one .npz
# --------------------------------------------------------------------------
def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def save_llsp(path: str, params) -> None:
    """Write LLSP params (the port's, on any device, or the reference's)
    to ``path``."""
    from repro_torch.convert import GBDT_FIELDS

    arrays = {f"{part}_{f}": _host(getattr(getattr(params, part), f))
              for part in ("router", "pruners") for f in GBDT_FIELDS}
    np.savez(path, levels=_host(params.levels), **arrays)


def load_llsp(path: str, device):
    from repro_torch.convert import llsp_params

    with np.load(path) as z:
        pick = lambda p: {k[len(p):]: z[k] for k in z.files
                          if k.startswith(p)}
        return llsp_params(pick("router_"), pick("pruners_"), z["levels"],
                           device=device)


# --------------------------------------------------------------------------
# the sharded engines
# --------------------------------------------------------------------------
ENGINE_ARRAYS = {"f32": ("centroids", "postings", "posting_ids"),
                 "q8": ("centroids", "q8", "qscale", "qnorm2",
                        "posting_ids")}


def serve(mesh: Mesh, job: dict) -> dict:
    from repro_torch.core.search import SearchConfig, \
        make_sharded_serve, make_sharded_serve_quantized
    from repro_torch.distributed.collectives import all_gather
    from repro_torch.distributed.sharding import batch_axes, gather_axes, \
        shard_local

    cfg = SearchConfig(**job["cfg"])
    work, dev = job["work"], mesh.device
    axes = batch_axes(mesh)
    make = make_sharded_serve_quantized if job["engine"] == "q8" \
        else make_sharded_serve
    fn = make(mesh, cfg, batch_axes=axes)
    arrays = [_block(work, name, spec, mesh)
              for name, spec in zip(ENGINE_ARRAYS[job["engine"]],
                                    fn.in_specs)]
    llsp = load_llsp(os.path.join(work, "llsp.npz"), dev) \
        if cfg.pruning == "llsp" else None
    queries = np.load(os.path.join(work, job.get("queries", "queries")
                                   + ".npy"))
    topk = np.load(os.path.join(work, job.get("topk", "topk") + ".npy"))
    bsz = job["batch"]
    qspec, tspec = fn.in_specs[-2], fn.in_specs[-1]
    blocks = [(torch.from_numpy(np.ascontiguousarray(
                  shard_local(queries[s:s + bsz], qspec, mesh))).to(dev),
               torch.from_numpy(np.ascontiguousarray(
                   shard_local(topk[s:s + bsz], tspec, mesh))).to(dev))
              for s in range(0, len(queries), bsz)]

    fn(*arrays, llsp, *blocks[0])                     # warm
    _sync(mesh)
    dist.barrier()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    outs = [fn(*arrays, llsp, q, tk) for q, tk in blocks]
    _sync(mesh)
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    outs = [[gather_axes(t, mesh, axes) for t in o] for o in outs]
    # the engine's own collectives replayed alone, at the same shapes and
    # count: an estimate of their share of the timed window
    b_loc = blocks[0][0].shape[0]
    group = mesh.group("model")
    k_loc = min(cfg.nprobe_max, arrays[0].shape[0])
    parts = [torch.zeros((b_loc, cfg.k), device=dev),
             torch.zeros((b_loc, cfg.k), dtype=torch.int32, device=dev)]
    if job["engine"] == "q8" or cfg.shard_centroids:
        parts += [torch.zeros((b_loc, k_loc), device=dev),
                  torch.zeros((b_loc, k_loc), dtype=torch.int64, device=dev)]
    _sync(mesh)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in blocks:
        for t in parts:
            all_gather(t, group)
    _sync(mesh)
    coll = time.perf_counter() - t0
    res = {"ms_per_batch": wall / len(blocks) * 1e3,
           "collective_share_replay": coll / wall, "launches": launches,
           "host_staged": mesh.host_staged, "rank": mesh.rank}
    if mesh.rank == 0:
        res.update({name: torch.cat([o[j] for o in outs]).cpu().numpy()
                    for j, name in enumerate(("dists", "ids", "nprobe"))})
    return res


# --------------------------------------------------------------------------
# one distributed Lloyd step
# --------------------------------------------------------------------------
def kmeans(mesh: Mesh, job: dict) -> dict:
    from repro_torch.build.kmeans import kmeans_sharded_step, \
        kmeans_sharded_sums
    from repro_torch.distributed.sharding import P

    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    x = _block(job["work"], "x", P(data_axes), mesh)
    cents = torch.from_numpy(np.load(os.path.join(job["work"],
                                                  "cents.npy"))).to(
        mesh.device)
    fused = job.get("fused", True)
    steps = job.get("steps", 1)
    if job.get("warm", True):
        kmeans_sharded_step(mesh, x, cents, cents.shape[0], fused)
    _sync(mesh)
    dist.barrier()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        new = kmeans_sharded_step(mesh, x, cents, cents.shape[0], fused)
    _sync(mesh)
    wall = time.perf_counter() - t0
    _, counts = kmeans_sharded_sums(mesh, x, cents, fused)
    launches = LAUNCHES.snapshot()
    res = {"ms_per_step": wall / steps * 1e3, "launches": launches,
           "rows": int(x.shape[0]), "rank": mesh.rank}
    if mesh.rank == 0:
        res.update(centroids=new.cpu().numpy(), counts=counts.cpu().numpy())
    return res


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------
def collectives(mesh: Mesh, job: dict) -> dict:
    from repro_torch.distributed.collectives import bucketed_psum, \
        compressed_psum, compressed_psum_tree, tree_map

    group = mesh.group(job.get("axis", "data"))
    dev = mesh.device
    tree = tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(dev),
                    job["tree"])
    scaled = tree_map(lambda t: t * float(mesh.index(job.get("axis",
                                                             "data")) + 1),
                      tree)
    LAUNCHES.reset()
    comp, _ = compressed_psum_tree(tree, group)
    buck = bucketed_psum(scaled, group,
                         bucket_bytes=job.get("bucket_bytes", 64 << 20))
    res = {"compressed": tree_map(lambda t: t.cpu().numpy(), comp),
           "bucketed": tree_map(lambda t: t.cpu().numpy(), buck),
           "launches": LAUNCHES.snapshot(), "host_staged": mesh.host_staged,
           "rank": mesh.rank}
    if "ef" in job:
        x = torch.from_numpy(np.asarray(job["ef"])).to(dev)
        out, err = compressed_psum(x, group)
        out2, _ = compressed_psum(x, group, err)
        res["ef"] = tuple(t.cpu().numpy() for t in (out, err, out2))
    return res


# --------------------------------------------------------------------------
# the row-sharded recsys tables
# --------------------------------------------------------------------------
def _timed(mesh: Mesh, fn):
    """(fn's result, its wall seconds between two barriers)."""
    _sync(mesh)
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh)
    return out, time.perf_counter() - t0


def _cut(params: dict, specs: dict, fn) -> dict:
    """``fn(leaf, spec)`` over a nested dict of parameters and the nested
    dict of their partition specs (whose leaves are tuples)."""
    return {k: _cut(v, specs[k], fn) if isinstance(v, dict)
            else fn(v, specs[k]) for k, v in params.items()}


def recsys(mesh: Mesh, job: dict) -> dict:
    import dataclasses

    from repro_torch import ckpt
    from repro_torch.configs import get
    from repro_torch.distributed.collectives import tree_map
    from repro_torch.distributed.sharding import P, batch_axes, \
        gather_axes, recsys_table_spec, shard_local
    from repro_torch.models.recsys import embedding_bag_sharded, \
        embedding_lookup_sharded, forward, param_shapes, param_specs

    work, dev = job["work"], mesh.device
    axes = batch_axes(mesh)
    res: dict = {"rank": mesh.rank, "host_staged": mesh.host_staged,
                 "seconds": {}}
    outs: dict = {}
    LAUNCHES.reset()
    with torch.no_grad():
        if job.get("embedding"):
            table = _block(work, "table", recsys_table_spec(), mesh)
            ids = _block(work, "ids", P(axes), mesh)
            weights = _block(work, "weights", P(axes), mesh) \
                if os.path.exists(os.path.join(work, "weights.npy")) \
                else None
            for name, fn in (
                    ("lookup", lambda: embedding_lookup_sharded(
                        table, ids, mesh, axes)),
                    ("bag", lambda: embedding_bag_sharded(
                        table, ids, mesh, weights, axes))):
                out, res["seconds"][name] = _timed(mesh, fn)
                outs[name] = gather_axes(out, mesh, axes)
            del table
        for arch_name in job.get("archs", ()):
            cfg = dataclasses.replace(get(arch_name).config,
                                      table_rows=job["rows"])
            like = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                            param_shapes(cfg))
            params, _, _ = ckpt.restore(
                like, os.path.join(work, f"{arch_name}_params"))
            params = _cut(params, param_specs(cfg),
                          lambda t, spec: shard_local(t, spec, mesh)
                          .contiguous().to(dev))
            with np.load(os.path.join(work, f"{arch_name}_batch.npz")) as z:
                batch = {k: torch.from_numpy(np.ascontiguousarray(
                    shard_local(z[k], P(axes), mesh))).to(dev)
                    for k in z.files}
            logits, res["seconds"][arch_name] = _timed(
                mesh, lambda: forward(params, batch, cfg, mesh, axes))
            outs[f"{arch_name}_logits"] = gather_axes(logits, mesh, axes)
    res["launches"] = LAUNCHES.snapshot()
    if mesh.rank == 0:
        for name, t in outs.items():
            np.save(os.path.join(work, f"{name}.npy"), t.cpu().numpy())
        res["files"] = sorted(outs)
    return res


_KINDS = {"serve": serve, "kmeans": kmeans, "collectives": collectives,
          "recsys": recsys}
