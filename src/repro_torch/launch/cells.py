"""Cell builders: (arch x shape x mesh) -> (step function, abstract
arguments, shardings) (port of ``repro.launch.cells``).

A "cell" is one dry-run unit: the step function of an architecture at one
input shape, with the partition specs of its arguments and outputs on the
production mesh, and its arguments as ``meta`` tensors of their global
shapes and dtypes, so nothing is ever allocated.  ``launch/dryrun.py``
places the arguments as DTensors by their specs
(``distributed/sharding.py`` ``distribute``) and runs the step on rank 0
of the fake mesh (``launch/mesh.py`` ``dry_mesh``).

MODEL_FLOPS conventions (the reference's, for the useful-compute ratio):
  train    6 * N(_active) * tokens
  prefill  2 * N(_active) * tokens
  decode   2 * N(_active) * batch          (one token per sequence)
  gnn      (see _gnn_model_flops) x3 for train
  recsys   per-arch analytic estimate x3 for train
  anns     2 * B * D * (C_scanned + nprobe*L) distance MACs->flops

The scan kernels are not used in the dry run (``use_kernel=False``, as in
the reference): on ``meta`` the plain path runs, whose flops and bytes are
the kernels' work.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import ArchDef, ShapeDef
from repro_torch.distributed.sharding import P, batch_axes, map_specs, \
    opt_specs
from repro_torch.optim import adamw

__all__ = ["Cell", "batch_axes", "dp_size", "f32_like", "opt_abstract",
           "BUILDERS", "OPT_OVERRIDES", "optimize_arch", "build_cell"]


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    abstract_args: tuple
    in_specs: tuple
    out_specs: Any               # tree of P, or None
    model_flops: float
    donate: tuple = ()
    note: str = ""


def dp_size(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _bspec(mesh, batch: int, *trailing) -> P:
    """Batch sharding that degrades to replication when batch < dp
    factors."""
    if batch % dp_size(mesh) == 0:
        return P(batch_axes(mesh), *trailing)
    if batch % mesh.shape["data"] == 0:
        return P("data", *trailing)
    return P(None, *trailing)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def f32_like(tree):
    from repro_torch.distributed.collectives import tree_map

    return tree_map(lambda s: _sds(s.shape, torch.float32), tree)


def opt_abstract(params_abs) -> adamw.AdamWState:
    return adamw.AdamWState(step=_sds((), torch.int32),
                            mu=f32_like(params_abs),
                            nu=f32_like(params_abs))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_cell(arch: ArchDef, shape: ShapeDef, mesh) -> Cell:
    from repro_torch.models.lm import transformer as tf

    cfg = arch.config
    tp = mesh.shape["model"]
    p_abs = tf.param_shapes(cfg)
    p_specs = tf.param_specs(cfg, tp=tp)
    b, s = shape.batch, shape.seq
    if cfg.pure_dp and b % (mesh.shape["data"] * tp) == 0:
        tokens_spec = P(("data", "model"), None)   # batch over BOTH axes
    else:
        tokens_spec = _bspec(mesh, b, None)

    if shape.kind == "train":
        o_abs = opt_abstract(p_abs)
        o_specs = opt_specs(p_specs, p_abs, mesh)
        tokens = _sds((b, s + 1), torch.int32)
        step = tf.make_train_step(cfg, mesh=mesh)
        mf = 6.0 * cfg.n_active_params * b * s
        return Cell(arch.name, shape.name, step,
                    (p_abs, o_abs, tokens),
                    (p_specs, o_specs, tokens_spec),
                    (p_specs, o_specs, None), mf,
                    donate=(0, 1))
    if shape.kind == "prefill":
        tokens = _sds((b, s), torch.int32)

        def step(params, tokens):
            return tf.prefill_step(params, tokens, cfg, mesh)

        mf = 2.0 * cfg.n_active_params * b * s
        return Cell(arch.name, shape.name, step, (p_abs, tokens),
                    (p_specs, tokens_spec), None, mf)
    if shape.kind == "decode":
        cache_abs = tf.cache_shapes(cfg, b, s)
        c_specs = tf.cache_specs(cfg, mesh)
        # batch dim of the cache follows the token batch sharding
        if b % dp_size(mesh) != 0:
            c_specs = map_specs(
                lambda sp: P(*[None if (isinstance(x, tuple)
                                        or x in ("pod", "data")) else x
                               for x in tuple(sp)]),
                c_specs)
        token = _sds((b,), torch.int32)
        pos = _sds((), torch.int32)

        def step(params, cache, token, pos):
            return tf.decode_step(params, cache, token, pos, cfg, mesh)

        mf = 2.0 * cfg.n_active_params * b
        return Cell(arch.name, shape.name, step,
                    (p_abs, cache_abs, token, pos),
                    (p_specs, c_specs, _bspec(mesh, b), P()),
                    (None, c_specs), mf, donate=(1,))
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------
def _gnn_model_flops(cfg, n_nodes, n_edges, d_feat, train=True) -> float:
    dh = cfg.d_hidden
    per_layer = 6 * dh * dh * n_edges + 6 * dh * dh * n_nodes
    enc = 2 * (d_feat * dh + dh * dh) * n_nodes
    dec = 2 * (dh * dh + dh * cfg.n_vars) * n_nodes
    f = cfg.n_layers * per_layer + enc + dec
    return (3.0 if train else 1.0) * f


def _gnn_cell(arch: ArchDef, shape: ShapeDef, mesh) -> Cell:
    from repro_torch.models.gnn import graphcast as gc

    cfg = arch.config
    n, e = shape.get("n_nodes"), shape.get("n_edges")
    d = shape.get("d_feat")
    mode = shape.get("mode")
    p_abs = gc.param_shapes(cfg, d)
    p_specs = gc.param_specs(cfg)
    o_abs = opt_abstract(p_abs)
    o_specs = opt_specs(p_specs, p_abs, mesh)
    ba = batch_axes(mesh)

    if mode == "batched":
        bsz = shape.batch
        batch_abs = {
            "node_feats": _sds((bsz, n, d), torch.float32),
            "src": _sds((bsz, e), torch.int32),
            "dst": _sds((bsz, e), torch.int32),
            "edge_mask": _sds((bsz, e), torch.bool),
            "targets": _sds((bsz, n, cfg.n_vars), torch.float32),
        }
        b_specs = {
            "node_feats": _bspec(mesh, bsz, None, None),
            "src": _bspec(mesh, bsz, None),
            "dst": _bspec(mesh, bsz, None),
            "edge_mask": _bspec(mesh, bsz, None),
            "targets": _bspec(mesh, bsz, None, None),
        }
        step = gc.make_train_step(cfg, batched=True, mesh=mesh)
        mf = _gnn_model_flops(cfg, n * bsz, e * bsz, d)
    else:
        batch_abs = {
            "node_feats": _sds((n, d), torch.float32),
            "src": _sds((e,), torch.int32),
            "dst": _sds((e,), torch.int32),
            "edge_mask": _sds((e,), torch.bool),
            "targets": _sds((n, cfg.n_vars), torch.float32),
            "node_mask": _sds((n,), torch.bool),
        }
        b_specs = {
            "node_feats": P(None, None),      # hidden dim shards via params
            "src": P(ba), "dst": P(ba), "edge_mask": P(ba),
            "targets": P(None, None),
            "node_mask": P(None),
        }
        step = gc.make_train_step(cfg, batched=False, mesh=mesh)
        if cfg.row_dp:
            # row-DP contract: node rows divide the flat mesh; pad N up
            n_flat = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
            n = -(-n // n_flat) * n_flat
            batch_abs["node_feats"] = _sds((n, d), torch.float32)
            batch_abs["targets"] = _sds((n, cfg.n_vars), torch.float32)
            batch_abs["node_mask"] = _sds((n,), torch.bool)
            ba_flat = tuple(mesh.axis_names)
            b_specs["node_feats"] = P(ba_flat, None)
            b_specs["targets"] = P(ba_flat, None)
            b_specs["node_mask"] = P(ba_flat)
            b_specs["src"] = P(ba_flat)
            b_specs["dst"] = P(ba_flat)
            b_specs["edge_mask"] = P(ba_flat)
            # edges must divide the flat mesh too
            e_flat = -(-e // n_flat) * n_flat
            for kk in ("src", "dst"):
                batch_abs[kk] = _sds((e_flat,), torch.int32)
            batch_abs["edge_mask"] = _sds((e_flat,), torch.bool)
        mf = _gnn_model_flops(cfg, n, e, d)
    return Cell(arch.name, shape.name, step,
                (p_abs, o_abs, batch_abs),
                (p_specs, o_specs, b_specs),
                (p_specs, o_specs, None), mf, donate=(0, 1))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------
def _recsys_model_flops(cfg, batch: int) -> float:
    d = cfg.embed_dim
    f = cfg.n_sparse
    fl = 0.0
    if cfg.kind == "xdeepfm":
        prev = f
        for hk in cfg.cin_layers:
            fl += 2 * prev * f * hk * d + prev * f * d
            prev = hk
        dims = (f * d,) + tuple(cfg.mlp) + (1,)
        fl += sum(2 * a * b_ for a, b_ in zip(dims[:-1], dims[1:]))
    elif cfg.kind == "wide_deep":
        dims = (f * d,) + tuple(cfg.mlp) + (1,)
        fl += sum(2 * a * b_ for a, b_ in zip(dims[:-1], dims[1:]))
    elif cfg.kind == "din":
        s = cfg.seq_len
        adims = (4 * d,) + tuple(cfg.attn_mlp) + (1,)
        fl += s * sum(2 * a * b_ for a, b_ in zip(adims[:-1], adims[1:]))
        mdims = ((cfg.n_sparse + 2) * d,) + tuple(cfg.mlp) + (1,)
        fl += sum(2 * a * b_ for a, b_ in zip(mdims[:-1], mdims[1:]))
    elif cfg.kind == "mind":
        s, i = cfg.seq_len, cfg.n_interests
        fl += 2 * s * d * d                       # bilinear map
        fl += cfg.capsule_iters * (4 * i * s * d)  # routing iterations
        fl += 2 * d * d + 2 * i * d               # label attention
    return float(fl * batch)


def _recsys_batch_abs(cfg, b: int, mesh) -> tuple[dict, dict]:
    abs_ = {
        "sparse_ids": _sds((b, cfg.n_sparse), torch.int32),
        "labels": _sds((b,), torch.float32),
    }
    specs = {
        "sparse_ids": _bspec(mesh, b, None),
        "labels": _bspec(mesh, b),
    }
    if cfg.seq_len:
        abs_["hist_ids"] = _sds((b, cfg.seq_len), torch.int32)
        abs_["hist_len"] = _sds((b,), torch.int32)
        specs["hist_ids"] = _bspec(mesh, b, None)
        specs["hist_len"] = _bspec(mesh, b)
    return abs_, specs


def _recsys_cell(arch: ArchDef, shape: ShapeDef, mesh) -> Cell:
    from repro_torch.models.recsys import models as rm

    cfg = arch.config
    ba = batch_axes(mesh)
    p_abs = rm.param_shapes(cfg)
    p_specs = rm.param_specs(cfg)

    if shape.kind == "train":
        b = shape.batch
        o_abs = opt_abstract(p_abs)
        o_specs = opt_specs(p_specs, p_abs, mesh)
        batch_abs, b_specs = _recsys_batch_abs(cfg, b, mesh)
        step = rm.make_train_step(cfg, mesh=mesh, batch_axes=ba)
        mf = 3.0 * _recsys_model_flops(cfg, b)
        return Cell(arch.name, shape.name, step,
                    (p_abs, o_abs, batch_abs),
                    (p_specs, o_specs, b_specs),
                    (p_specs, o_specs, None), mf, donate=(0, 1))
    if shape.kind == "serve":
        b = shape.batch
        batch_abs, b_specs = _recsys_batch_abs(cfg, b, mesh)
        batch_abs.pop("labels")
        b_specs.pop("labels")

        def step(params, batch):
            return torch.sigmoid(rm.forward(params, batch, cfg, mesh, ba))

        mf = _recsys_model_flops(cfg, b)
        return Cell(arch.name, shape.name, step, (p_abs, batch_abs),
                    (p_specs, b_specs), None, mf)
    if shape.kind == "retrieval":
        nc = shape.get("n_candidates")
        d = cfg.embed_dim
        cand = _sds((nc, d), torch.float32)
        cand_spec = P("model", None)
        if cfg.kind == "mind":
            hist = _sds((1, cfg.seq_len), torch.int32)
            hlen = _sds((1,), torch.int32)

            def step(params, hist_ids, hist_len, cand):
                # single-user tower: batch replicated (batch=1 < data axis)
                return rm.mind_retrieval(params, hist_ids, hist_len, cand,
                                         cfg, mesh, k=100)

            mf = 2.0 * nc * d * cfg.n_interests + _recsys_model_flops(cfg, 1)
            return Cell(arch.name, shape.name, step,
                        (p_abs, hist, hlen, cand),
                        (p_specs, P(None, None), P(None), cand_spec),
                        None, mf,
                        note="1 user x 1M candidates, batched dot + top-k")
        # ranking archs: bulk-score the 1M candidates through the model
        b = nc
        batch_abs, b_specs = _recsys_batch_abs(cfg, b, mesh)
        batch_abs.pop("labels")
        b_specs.pop("labels")

        def step(params, batch):
            return torch.sigmoid(rm.forward(params, batch, cfg, mesh, ba))

        mf = _recsys_model_flops(cfg, b)
        return Cell(arch.name, shape.name, step, (p_abs, batch_abs),
                    (p_specs, b_specs), None, mf,
                    note="1 user x 1M candidates scored as a bulk batch")
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# ANNS (Helmsman) cells
# ---------------------------------------------------------------------------
def _llsp_abstract(n_levels: int = 4, trees: int = 64, nodes: int = 63):
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.core.llsp import LLSPParams

    def gb(lead):
        return GBDTParams(
            feature=_sds(lead + (trees, nodes), torch.int32),
            threshold=_sds(lead + (trees, nodes), torch.float32),
            value=_sds(lead + (trees, nodes), torch.float32),
            base=_sds(lead, torch.float32),
            lr=_sds(lead, torch.float32))

    return LLSPParams(router=gb(()), pruners=gb((n_levels,)),
                      levels=_sds((n_levels,), torch.int32))


def _anns_cell(arch: ArchDef, shape: ShapeDef, mesh) -> Cell:
    from repro_torch.core.search import SearchConfig, make_sharded_serve

    hc = arch.config
    ba = batch_axes(mesh)

    if shape.kind == "anns_serve":
        b = shape.batch
        scfg = SearchConfig(k=hc.k, nprobe_max=hc.nprobe_max,
                            pruning="llsp", use_kernel=False)
        C, L, D = hc.n_clusters, hc.cluster_len, hc.dim
        cents = _sds((C, D), torch.float32)
        posts = _sds((C, L, D), torch.float32)
        pids = _sds((C, L), torch.int32)
        llsp = _llsp_abstract()
        queries = _sds((b, D), torch.float32)
        topk = _sds((b,), torch.int32)
        fn = make_sharded_serve(mesh, scfg, batch_axes=ba,
                                shard_axis="model")
        llsp_spec = map_specs(lambda _, __: P(), _llsp_spec_tree(llsp),
                              llsp)
        # distance flops: centroid scan (B x C x D per model shard,
        # replicated in the baseline) + posting scan (B x nprobe x L x D)
        mf = 2.0 * b * D * (C + hc.nprobe_max * L)
        return Cell(arch.name, shape.name, fn,
                    (cents, posts, pids, llsp, queries, topk),
                    (P(), P("model"), P("model"), llsp_spec,
                     _bspec(mesh, b, None), _bspec(mesh, b)),
                    None, mf,
                    note="paper's serving path: LLSP + sharded posting "
                         "scan + k-merge")
    if shape.kind == "anns_build":
        from repro_torch.build.kmeans import kmeans_sharded_step

        n = shape.batch
        k = shape.get("k_coarse")
        D = hc.dim
        x = _sds((n, D), torch.float32)
        cents = _sds((k, D), torch.float32)

        def step(x, cents):
            return kmeans_sharded_step(mesh, x, cents, k, fused=False)

        mf = 2.0 * n * k * D
        return Cell(arch.name, shape.name, step, (x, cents),
                    (_bspec(mesh, n, None), P(None, None)), P(None, None),
                    mf, note="one distributed Lloyd iteration (stage-1 "
                             "build)")
    raise ValueError(shape.kind)


def _llsp_spec_tree(llsp):
    """A spec-shaped skeleton of the LLSP dataclasses (every leaf a P)."""
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.core.llsp import LLSPParams

    gb = lambda: GBDTParams(*(P() for _ in range(5)))
    return LLSPParams(router=gb(), pruners=gb(), levels=P())


BUILDERS = {
    "lm": _lm_cell,
    "gnn": _gnn_cell,
    "recsys": _recsys_cell,
    "anns": _anns_cell,
}

# beyond-baseline per-arch optimizations (the reference's):
#   * pad_heads_to   - heads shard over TP=16, killing the O(S^2) score psum
#                      that Dh-sharding forces (phi4: 24->32, llama4: 40->48)
#   * seq_parallel   - Megatron-SP activation sharding between blocks
#   * shard_centroids + int8 postings - Helmsman serving memory/compute
OPT_OVERRIDES = {
    # head padding: a win wherever scores are O(S^2) (train/prefill);
    # slightly negative at decode (Tq=1, no score psum) -> decode stays base
    ("phi4_mini", "prefill"): dict(pad_heads_to=32),
    ("phi4_mini", "train"): dict(pad_heads_to=32, seq_parallel=True),
    ("llama4_scout", "prefill"): dict(pad_heads_to=48),
    ("llama4_scout", "train"): dict(pad_heads_to=48, seq_parallel=True),
    ("gemma3_12b", "train"): dict(pure_dp=True),
    ("gemma3_27b", "train"): dict(seq_parallel=True),
    ("qwen2_moe", "train"): dict(seq_parallel=True),
}


def optimize_arch(arch: ArchDef, shape_name: str) -> ArchDef:
    if arch.family == "gnn":
        mode = arch.shapes[shape_name].get("mode")
        if mode == "full":   # full-graph cells: row-DP + dst-sorted edges
            cfg = dataclasses.replace(arch.config, row_dp=True)
            return dataclasses.replace(arch, config=cfg)
        return arch
    if arch.family != "lm":
        return arch
    kind = arch.shapes[shape_name].kind
    ov = OPT_OVERRIDES.get((arch.name, kind),
                           OPT_OVERRIDES.get((arch.name, "*")))
    if ov:
        cfg = dataclasses.replace(arch.config, **ov)
        return dataclasses.replace(arch, config=cfg)
    return arch


def build_cell(arch: ArchDef, shape_name: str, mesh,
               variant: str = "base") -> Cell:
    if variant == "opt":
        arch = optimize_arch(arch, shape_name)
    shape = arch.shapes[shape_name]
    cell = BUILDERS[arch.family](arch, shape, mesh)
    if variant == "opt" and arch.family == "anns" \
            and shape.kind == "anns_serve":
        cell = _anns_cell_opt(arch, shape, mesh)
    return cell


def _anns_cell_opt(arch: ArchDef, shape: ShapeDef, mesh) -> Cell:
    """Optimized Helmsman serving: sharded centroid scan + int8 residual
    postings (4x fewer scan bytes)."""
    from repro_torch.core.search import SearchConfig, \
        make_sharded_serve_quantized

    base = _anns_cell(arch, shape, mesh)
    hc = arch.config
    ba = batch_axes(mesh)
    scfg = SearchConfig(k=hc.k, nprobe_max=hc.nprobe_max, pruning="llsp",
                        use_kernel=False, shard_centroids=True)
    fn = make_sharded_serve_quantized(mesh, scfg, batch_axes=ba,
                                      shard_axis="model")
    C, L, D = hc.n_clusters, hc.cluster_len, hc.dim
    cents, _posts, pids, llsp, queries, topk = base.abstract_args
    args = (
        cents,
        _sds((C, L, D), torch.int8),        # q8 residuals
        _sds((C, 1, 1), torch.float32),     # per-cluster scale
        _sds((C, L), torch.float32),        # precomputed norms
        pids, llsp, queries, topk,
    )
    specs = (P("model"), P("model"), P("model"), P("model"), P("model"),
             base.in_specs[3], base.in_specs[4], base.in_specs[5])
    return dataclasses.replace(
        base, fn=fn, abstract_args=args, in_specs=specs,
        note=base.note + " [opt: sharded centroid scan + int8 residual "
                         "postings]")
