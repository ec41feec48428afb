"""Helmsman online search (port of ``repro.core.search``).

Per query batch:

  1. the LLSP router picks the level (max nprobe);
  2. the centroid scan returns the nmax nearest centroids (brute force, or
     the two-level group quantizer);
  3. the level pruner refines nprobe;
  4. one batched posting scan: the fused scan kernels (f32 ``ivf_scan_topk``
     or q8 ``ivf_scan_q8_topk``) keep (B, ~2k) unique-by-id candidates, or
     the legacy scan writes (B, P, L) distances (``fused_topk=False``);
  5. dedup + global top-k merge.

``serve_step`` runs the whole batch at ``nprobe_max``; ``serve_leveled``
routes on the host and scans each level's bucket at that level's bound.

The sharded engines (``make_sharded_serve``,
``make_sharded_serve_quantized``) stripe clusters over the ``model`` mesh
axis and split queries over the data axes (``launch/mesh.py``); each rank
scans its own clusters and the per-shard top-k are merged with one
all-gather of k candidates, the multi-SSD array and front-end merge of the
paper's Fig. 2a.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops

from . import llsp as llsp_mod
from .distance import (
    INF, dedup_topk, merge_candidate_topk, squared_l2, topk_smallest,
)
from .ivf import IVFIndex
from .spann_rules import fixed_eps_nprobe


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    k: int = 10
    nprobe_max: int = 64          # == LLSP nmax when pruning == "llsp"
    pruning: str = "none"         # "llsp" | "fixed" | "none"
    eps: float = 0.12             # fixed-eps baseline knob (Eq. 1)
    n_ratio: int = 32
    use_kernel: bool = True       # the scan kernels (False: their oracles,
                                  # an explicit A/B arm)
    two_level: bool = False       # group quantizer for the centroid scan
    n_groups_probe: int = 8
    fused_topk: bool = True       # candidate-compressed scan; False = the
                                  # legacy (B, P, L) distance path
    n_cand: int = 0               # candidates per query the scan keeps
                                  # (0 = auto: ~2k rounded up to 8)
    tier: str = "f32"             # first-pass payload: "f32" scans
                                  # index.postings, "q8" the attached int8
                                  # residuals (quantize.attach_quantized)
    shard_centroids: bool = False # sharded engine: each shard scans its
                                  # C/S centroid slice, then one (B, nmax)
                                  # all-gather and a re-rank


def _auto_ncand(k: int) -> int:
    """Default candidate width: ~2k, padded to a multiple of 8."""
    return -(-max(2 * k, 16) // 8) * 8


def _fused_scan_candidates(cfg: SearchConfig, kernel_call, ref_call):
    """Run the scan stage at width n_cand (kernel or oracle per
    ``cfg.use_kernel``), then merge to ``cfg.k``.  ``kernel_call`` and
    ``ref_call`` take k2 and return ((B, k2) dists, (B, k2) ids)."""
    k2 = cfg.n_cand or _auto_ncand(cfg.k)
    cd, ci = kernel_call(k2) if cfg.use_kernel else ref_call(k2)
    return merge_candidate_topk(cd, ci, cfg.k)


def centroid_scan(index: IVFIndex, queries: torch.Tensor, nmax: int,
                  cfg: Optional[SearchConfig] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-nmax centroids: (cdists (B, nmax) ascending, cids (B, nmax)
    int32).  With ``cfg.two_level`` and a group quantizer on the index, only
    the members of the ``n_groups_probe`` nearest groups are ranked (padded
    with (+inf, -1) when they number fewer than nmax)."""
    if cfg is not None and cfg.two_level \
            and index.group_centroids is not None:
        gd = squared_l2(queries, index.group_centroids)         # (B, G)
        _, gsel = topk_smallest(gd, cfg.n_groups_probe)         # (B, g)
        b = queries.shape[0]
        cand = index.group_members[gsel].reshape(b, -1)         # (B, M)
        cvecs = index.centroids[torch.clamp_min(cand, 0).long()]
        d = torch.sum((cvecs - queries[:, None, :]) ** 2, dim=-1)
        d = torch.where(cand < 0, INF, d)
        vals, pos = topk_smallest(d, min(nmax, d.shape[1]))
        cids = torch.gather(cand, 1, pos).to(torch.int32)
        if cids.shape[1] < nmax:                  # tiny-group configs
            padn = nmax - cids.shape[1]
            cids = torch.cat([cids, cids.new_full((b, padn), -1)], dim=1)
            vals = torch.cat([vals, vals.new_full((b, padn), INF)], dim=1)
        return vals, cids
    vals, cids = topk_smallest(squared_l2(queries, index.centroids), nmax)
    return vals, cids.to(torch.int32).contiguous()


def decide_nprobe(cfg: SearchConfig,
                  llsp_params: Optional[llsp_mod.LLSPParams],
                  queries: torch.Tensor, topk_req: torch.Tensor,
                  cdists: torch.Tensor) -> torch.Tensor:
    """Per-query nprobe (B,) int32 according to the pruning mode."""
    b = queries.shape[0]
    nmax = cdists.shape[1]
    if cfg.pruning == "none":
        return torch.full((b,), nmax, dtype=torch.int32,
                          device=queries.device)
    if cfg.pruning == "fixed":
        return fixed_eps_nprobe(cdists, cfg.eps, nmax)
    if cfg.pruning != "llsp" or llsp_params is None:
        raise ValueError(f"pruning={cfg.pruning!r} needs LLSP params")
    level = llsp_mod.route(llsp_params, queries, topk_req)
    return llsp_mod.prune(llsp_params, level, queries, topk_req, cdists,
                          cfg.n_ratio)


def _scan_and_rank(index: IVFIndex, queries: torch.Tensor,
                   cids: torch.Tensor, probe_mask: torch.Tensor,
                   cfg: SearchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Posting scan + top-k: ((B, k) dists, (B, k) ids).

    ``cfg.tier`` picks the payload (f32 postings or the attached q8
    residuals) and ``cfg.fused_topk`` the data path: the fused scan keeps
    (B, n_cand) unique-by-id candidates and a cheap merge takes k; the
    legacy path writes (B, P, L) distances, masks pad ids and runs a dedup
    top-k over P * L columns."""
    from repro_torch.kernels import ref as kref

    b = queries.shape[0]
    if cfg.tier == "q8":
        if index.q8 is None:
            raise ValueError(
                "SearchConfig(tier='q8') needs an index with the quantized "
                "payload attached; see core.quantize.attach_quantized")
        if cfg.fused_topk:
            args = (index.q8, index.qscale, index.qnorm2, index.centroids,
                    index.posting_ids, cids, probe_mask, queries)
            return _fused_scan_candidates(
                cfg, lambda k2: kops.ivf_scan_q8_topk(*args, k2=k2),
                lambda k2: kref.ivf_scan_q8_topk_ref(*args, k2=k2))
        from .quantize import QuantizedPostings, ivf_scan_quantized

        qp = QuantizedPostings(q8=index.q8, scale=index.qscale,
                               norm2=index.qnorm2)
        dists = ivf_scan_quantized(qp, index.centroids, cids, probe_mask,
                                   queries)
    elif cfg.fused_topk:
        args = (index.postings, index.posting_ids, cids, probe_mask, queries)
        return _fused_scan_candidates(
            cfg, lambda k2: kops.ivf_scan_topk(*args, k2=k2),
            lambda k2: kref.ivf_scan_topk_ref(*args, k2=k2))
    else:
        scan = kops.ivf_scan if cfg.use_kernel else kref.ivf_scan_ref
        dists = scan(index.postings, cids, probe_mask, queries)
    ids = index.posting_ids[torch.clamp_min(cids, 0).long()]     # (B, P, L)
    dists = torch.where(ids < 0, INF, dists)
    return dedup_topk(dists.reshape(b, -1), ids.reshape(b, -1), cfg.k)


def serve_step(index: IVFIndex, llsp_params: Optional[llsp_mod.LLSPParams],
               queries: torch.Tensor, topk_req: torch.Tensor,
               cfg: SearchConfig) -> dict:
    """Single-device search of one batch on the index's device: a dict of
    ``ids`` (B, k), ``dists`` (B, k) and ``nprobe`` (B,) tensors."""
    nmax = cfg.nprobe_max
    cdists, cids = centroid_scan(index, queries, nmax, cfg)
    nprobe = decide_nprobe(cfg, llsp_params, queries, topk_req, cdists)
    probe_mask = (torch.arange(nmax, device=queries.device)[None, :]
                  < nprobe[:, None]) & (cids >= 0)
    dists, ids = _scan_and_rank(index, queries, cids, probe_mask, cfg)
    return {"ids": ids, "dists": dists, "nprobe": nprobe}


# --------------------------------------------------------------------------
# leveled serving: each LLSP level scans its bucket at that level's bound
# --------------------------------------------------------------------------
def _serve_at_level(index, llsp_params, queries, topk_req, level_idx: int,
                    bound: int, cfg: SearchConfig) -> dict:
    nmax_feat = max(bound, cfg.n_ratio + 1)   # pruner features need n_ratio+1
    cdists, cids = centroid_scan(index, queries, nmax_feat, cfg)
    level = torch.full((queries.shape[0],), level_idx, dtype=torch.int32,
                       device=queries.device)
    nprobe = llsp_mod.prune(llsp_params, level, queries, topk_req, cdists,
                            cfg.n_ratio)
    nprobe = torch.clamp_max(nprobe, bound)
    cids = cids[:, :bound].contiguous()
    probe_mask = (torch.arange(bound, device=queries.device)[None, :]
                  < nprobe[:, None]) & (cids >= 0)
    dists, ids = _scan_and_rank(index, queries, cids, probe_mask, cfg)
    return {"ids": ids, "dists": dists, "nprobe": nprobe}


def serve_leveled(index: IVFIndex, llsp_params: llsp_mod.LLSPParams,
                  queries, topk_req, cfg: SearchConfig, pad: int = 64
                  ) -> dict:
    """Route on the host, then scan each level's bucket of queries with
    nprobe capped at that level's bound.  Buckets are padded to multiples
    of ``pad`` by repeating their first query, so every row is computed as
    in the reference.  Returns numpy ``ids``, ``dists``, ``nprobe`` and the
    routed ``levels``."""
    dev = index.device
    q = np.asarray(queries, dtype=np.float32)
    tk = np.asarray(topk_req, dtype=np.int32)
    b = q.shape[0]
    qd = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
    tkd = torch.from_numpy(np.ascontiguousarray(tk)).to(dev)
    lv = llsp_mod.route(llsp_params, qd, tkd).cpu().numpy()
    bounds = llsp_params.levels.cpu().numpy()
    out_d = np.full((b, cfg.k), np.inf, np.float32)
    out_i = np.full((b, cfg.k), -1, np.int32)
    out_np = np.zeros((b,), np.int32)
    for li in range(int(bounds.shape[0])):
        sel = np.nonzero(lv == li)[0]
        if sel.size == 0:
            continue
        padded = -(-sel.size // pad) * pad
        rows = torch.from_numpy(np.concatenate(
            [sel, np.full(padded - sel.size, sel[0])])).to(dev)
        res = _serve_at_level(index, llsp_params, qd[rows], tkd[rows], li,
                              int(bounds[li]), cfg)
        out_d[sel] = res["dists"].cpu().numpy()[: sel.size]
        out_i[sel] = res["ids"].cpu().numpy()[: sel.size]
        out_np[sel] = res["nprobe"].cpu().numpy()[: sel.size]
    return {"ids": out_i, "dists": out_d, "nprobe": out_np, "levels": lv}


# --------------------------------------------------------------------------
# sharded engines: clusters striped over `model`, queries over data axes
# --------------------------------------------------------------------------
def _sharded_centroid_scan(queries, centroids_l, nmax: int, shard: int,
                           group) -> tuple[torch.Tensor, torch.Tensor]:
    """Each shard ranks its C/S centroid slice; one (S, B, k_loc)
    all-gather (in axis order) and a re-rank give the global top-nmax."""
    from repro_torch.distributed.collectives import all_gather

    c_slice = centroids_l.shape[0]
    dv, di = topk_smallest(squared_l2(queries, centroids_l),
                           min(nmax, c_slice))
    di = di + shard * c_slice                     # global centroid ids
    b = queries.shape[0]
    dv_all = torch.stack(all_gather(dv, group), dim=1).reshape(b, -1)
    di_all = torch.stack(all_gather(di, group), dim=1).reshape(b, -1)
    cdists, pos = topk_smallest(dv_all, nmax)
    return cdists, torch.gather(di_all, 1, pos)


def _sharded_local_search(mesh, cfg: SearchConfig, shard_axis: str):
    """This rank's search of its query block over its cluster stripe,
    merged across the ``shard_axis`` shards: a function of (the local
    IVFIndex, whose centroids are replicated or this shard's slice, LLSP
    params, queries, topk_req) -> this rank's rows of (dists, ids,
    nprobe)."""
    from repro_torch.distributed.collectives import all_gather

    n_shards = mesh.size(shard_axis)
    shard = mesh.index(shard_axis)
    group = mesh.group(shard_axis)

    def search(local_index, llsp_params, queries, topk_req):
        centroids = local_index.centroids
        c_local = local_index.posting_ids.shape[0]
        lo = shard * c_local
        nmax = cfg.nprobe_max
        if cfg.shard_centroids:
            cdists, cids = _sharded_centroid_scan(queries, centroids, nmax,
                                                  shard, group)
        else:
            cdists, cids = topk_smallest(squared_l2(queries, centroids),
                                         nmax)
        nprobe = decide_nprobe(cfg, llsp_params, queries, topk_req, cdists)
        probe_mask = (torch.arange(nmax, device=queries.device)[None, :]
                      < nprobe[:, None])
        # restrict to the clusters striped on this shard
        local_cids = cids - lo
        probe_mask = probe_mask & (local_cids >= 0) & (local_cids < c_local)
        local_cids = torch.clamp(local_cids, 0, c_local - 1).to(torch.int32)
        dists_k, ids_k = _scan_and_rank(local_index, queries, local_cids,
                                        probe_mask, cfg)
        # merge across shards: each shard's k candidates, re-ranked
        b = queries.shape[0]
        all_d = torch.stack(all_gather(dists_k, group), dim=1)
        all_i = torch.stack(all_gather(ids_k, group), dim=1)
        fd, fi = merge_candidate_topk(all_d.reshape(b, n_shards * cfg.k),
                                      all_i.reshape(b, n_shards * cfg.k),
                                      cfg.k)
        return fd, fi, nprobe

    return search


def make_sharded_serve(mesh, cfg: SearchConfig, *,
                       batch_axes: tuple = ("data",),
                       shard_axis: str = "model"):
    """The sharded engine over f32 postings, for this rank of ``mesh``.

    Returns ``local_search(centroids, postings, posting_ids, llsp_params,
    queries, topk_req)``, which takes this rank's blocks (its
    ``in_specs``: centroids replicated, or this shard's slice with
    ``cfg.shard_centroids``; postings and ids striped on the cluster dim
    over ``shard_axis``; LLSP replicated; queries and topk over
    ``batch_axes``) and returns this rank's rows of ``(dists, ids,
    nprobe)`` (its ``out_specs``).  Every rank of the mesh calls it once a
    batch: the all-gathers are collective.  Given DTensors (the global
    arrays), it returns DTensors."""
    from repro_torch.distributed.sharding import P

    search = _sharded_local_search(mesh, cfg, shard_axis)

    def local_search(centroids, postings, posting_ids, llsp_params, queries,
                     topk_req):
        return search(IVFIndex(centroids, postings, posting_ids),
                      llsp_params, queries, topk_req)

    bspec = P(tuple(batch_axes))
    cent = P(shard_axis) if cfg.shard_centroids else P()
    return _global_view(local_search, mesh,
                        (cent, P(shard_axis), P(shard_axis), P(), bspec,
                         bspec), (bspec, bspec, bspec))


def _global_view(local_search, mesh, in_specs, out_specs):
    """``local_search`` that also takes the global arrays as DTensors
    (the reference's ``shard_map`` as a ``local_map``); its
    ``in_specs`` and ``out_specs`` are the reference's."""
    from repro_torch.distributed.sharding import local_region

    fn = local_region(local_search, mesh, in_specs, out_specs)
    fn.in_specs, fn.out_specs = in_specs, out_specs
    return fn


def make_sharded_serve_quantized(mesh, cfg: SearchConfig, *,
                                 batch_axes: tuple = ("data",),
                                 shard_axis: str = "model"):
    """The sharded engine over int8 residual postings (core/quantize.py):
    ``local_search(centroids_l, q8, scale, norm2, posting_ids,
    llsp_params, queries, topk_req)``, every array but the LLSP params, the
    queries and topk striped on the cluster dim.  The centroid scan is
    sharded as with ``shard_centroids``, and the scan reads each cluster's
    own centroid from the local slice for the residual."""
    from repro_torch.distributed.sharding import P

    search = _sharded_local_search(
        mesh, dataclasses.replace(cfg, tier="q8", shard_centroids=True),
        shard_axis)

    def local_search(centroids_l, q8, scale, norm2, posting_ids,
                     llsp_params, queries, topk_req):
        return search(IVFIndex(centroids_l, None, posting_ids, q8=q8,
                               qscale=scale, qnorm2=norm2),
                      llsp_params, queries, topk_req)

    bspec = P(tuple(batch_axes))
    s = P(shard_axis)
    return _global_view(local_search, mesh,
                        (s, s, s, s, s, P(), bspec, bspec),
                        (bspec, bspec, bspec))
