"""GraphCast-style encoder-processor-decoder mesh GNN (arXiv:2212.12794;
port of ``repro.models.gnn.graphcast``).

The model runs on any (n_nodes, n_edges, d_feat) graph given as an edge
index, in three regimes:

* ``full graph``: one big graph; nodes and edges as flat arrays.
* ``sampled``: a layered neighbor-sampled subgraph (minibatch_lg): padded
  edge lists with an edge mask, the loss on the seed nodes (``node_mask``).
* ``batched``: (batch, nodes, ...) small molecule graphs
  (``forward_batched``: each graph's node ids offset into one flat graph,
  which computes what the reference's ``vmap`` does).

Message passing is a gather of the edge endpoints and a scatter-add into
the destination nodes (``segment_sum``), each of which repeats bit for bit
(a step too): the scatter-add is ``index_put_(accumulate=True)`` on the
card, which sorts the indices and sums each node's messages in a fixed
order, and ``index_add_`` on the CPU, which adds them in order (each
kernel accumulates in parallel on the other device); the gathers are
``F.embedding``, whose backward is deterministic on both.

Per GraphCast: an encoder MLP lifts the input features to d_hidden;
``n_layers`` processor blocks of (edge MLP -> aggregate -> node MLP) with
residuals and LayerNorm, each recomputed in the backward (remat); a
decoder MLP emits n_vars outputs per node.

On a :class:`repro_torch.launch.mesh.Mesh` the arguments are DTensors of
the global arrays placed by the reference's specs (global view), and each
of the reference's ``shard_map`` regions is a ``local_map``
(``distributed/sharding.py`` ``local_region``):

* ``forward_rowdp``: node rows and dst-sorted edges split over every mesh
  axis, one all-gather of the hidden rows a layer (a reduce-scatter in
  the backward); it also takes each rank's blocks as plain tensors;
* ``sharded_mp``: the hidden dim over ``model``; each rank gathers its
  edges' endpoints from its columns (``_gather_sharded``) and
  scatter-adds its edges into every node, summed over the batch axes
  (``_scatter_sum_sharded``);
* the base layout: the weights' hidden dim over ``model`` by placements,
  DTensor's rules for the rest, and the scatter-add (which DTensor has no
  rule for) in the same region as ``sharded_mp``'s;
* ``forward_batched``: each rank's graphs whole, one region.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6
    aggregator: str = "sum"
    dtype: Any = torch.float32
    sharded_mp: bool = False   # the reference's shard_map gather/scatter
                               # under feature TP (refuted there)
    row_dp: bool = False       # weights replicated, nodes and edges
                               # row-sharded over every mesh axis, edges
                               # dst-sorted: one node all-gather a layer


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _mlp_shapes(d_in: int, d_hidden: int, d_out: int, dtype) -> dict:
    sd = lambda s: _meta(s, dtype)
    return {
        "w1": sd((d_in, d_hidden)), "b1": sd((d_hidden,)),
        "w2": sd((d_hidden, d_out)), "b2": sd((d_out,)),
    }


def param_shapes(cfg: GNNConfig, d_feat: int) -> dict:
    """The parameter tree as ``meta`` tensors; the processor's leaves are
    stacked over layers."""
    dh = cfg.d_hidden
    dt = cfg.dtype
    sd = lambda s: _meta(s, dt)
    L = cfg.n_layers
    return {
        "encoder": _mlp_shapes(d_feat, dh, dh, dt),
        "proc": {
            # the edge MLP eats the [src, dst] concat
            "edge_w1": sd((L, 2 * dh, dh)), "edge_b1": sd((L, dh)),
            "edge_w2": sd((L, dh, dh)), "edge_b2": sd((L, dh)),
            "node_w1": sd((L, 2 * dh, dh)), "node_b1": sd((L, dh)),
            "node_w2": sd((L, dh, dh)), "node_b2": sd((L, dh)),
            "ln_node": sd((L, dh)), "ln_edge": sd((L, dh)),
        },
        "decoder": _mlp_shapes(dh, dh, cfg.n_vars, dt),
    }


def param_specs(cfg: GNNConfig) -> dict:
    """Hidden dim over ``model`` (TP); with ``cfg.row_dp`` every weight is
    replicated instead."""
    from repro_torch.distributed.collectives import tree_map
    from repro_torch.distributed.sharding import P

    if cfg.row_dp:
        return tree_map(lambda _: P(), param_shapes(cfg, 1))
    mlp = lambda: {"w1": P(None, "model"), "b1": P("model"),
                   "w2": P("model", None), "b2": P()}
    return {
        "encoder": mlp(),
        "proc": {
            "edge_w1": P(None, None, "model"), "edge_b1": P(None, "model"),
            "edge_w2": P(None, "model", None), "edge_b2": P(),
            "node_w1": P(None, None, "model"), "node_b1": P(None, "model"),
            "node_w2": P(None, "model", None), "node_b2": P(),
            "ln_node": P(), "ln_edge": P(),
        },
        "decoder": mlp(),
    }


def init_params(cfg: GNNConfig, d_feat: int, generator: torch.Generator,
                device=None) -> dict:
    """The reference's rule: a leaf of rank >= 2 is normal /
    sqrt(shape[-2]), any other leaf zeros, the LayerNorm gains ones.
    Standard normals come from ``generator`` (on its device) in the tree's
    leaf order; the leaves go to ``device`` (default: the generator's)."""
    from repro_torch.distributed.collectives import tree_map

    gdev = generator.device
    dev = torch.device(device) if device is not None else gdev

    def draw(s: torch.Tensor) -> torch.Tensor:
        if s.dim() >= 2:
            x = torch.randn(s.shape, generator=generator, dtype=s.dtype,
                            device=gdev) / math.sqrt(s.shape[-2])
            return x.to(dev)
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)

    p = tree_map(draw, param_shapes(cfg, d_feat))
    p["proc"]["ln_node"] = torch.ones_like(p["proc"]["ln_node"])
    p["proc"]["ln_edge"] = torch.ones_like(p["proc"]["ln_edge"])
    return p


def _mlp(x: torch.Tensor, mp: dict) -> torch.Tensor:
    h = F.silu(x @ mp["w1"] + mp["b1"])
    return h @ mp["w2"] + mp["b2"]


def _layer_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g).to(x.dtype)


def _in_range(ids: torch.Tensor, n: int) -> torch.Tensor:
    return (ids >= 0) & (ids < n)


def segment_sum(m: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``m`` summed into ``n`` segments by ``ids`` (ids outside
    [0, n) dropped, as ``jax.ops.segment_sum`` drops them), in a fixed
    order on either device (module doc)."""
    ok = _in_range(ids, n)
    if m.device.type != "meta" and not bool(ok.all()):   # meta: no values
        m, ids = m[ok], ids[ok]
    out = torch.zeros((n,) + tuple(m.shape[1:]), dtype=m.dtype,
                      device=m.device)
    if m.is_cuda:
        return out.index_put((ids.long(),), m, accumulate=True)
    return out.index_add(0, ids.long(), m)


def segment_max(m: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Row-wise maximum of ``m`` into ``n`` segments; an empty segment is
    -inf (``jax.ops.segment_max``)."""
    ok = _in_range(ids, n)
    if not bool(ok.all()):
        m, ids = m[ok], ids[ok]
    out = torch.full((n,) + tuple(m.shape[1:]), -math.inf, dtype=m.dtype,
                     device=m.device)
    index = ids.long().reshape(-1, *([1] * (m.dim() - 1))).expand_as(m)
    return out.scatter_reduce(0, index, m, "amax", include_self=False)


def _messages(h_src: torch.Tensor, h_dst: torch.Tensor, lp: dict,
              edge_mask: Optional[torch.Tensor]) -> torch.Tensor:
    e_in = torch.cat([h_src, h_dst], dim=-1)                # (E, 2dh)
    del h_src, h_dst                # the gathers: (E, dh) each
    m = F.silu(e_in @ lp["edge_w1"] + lp["edge_b1"])
    del e_in
    m = m @ lp["edge_w2"] + lp["edge_b2"]
    m = _layer_norm(m, lp["ln_edge"])
    if edge_mask is not None:
        m = torch.where(edge_mask[:, None], m, 0.0)
    return m


def _update(h: torch.Tensor, agg: torch.Tensor, lp: dict) -> torch.Tensor:
    u = torch.cat([h, agg], dim=-1)
    upd = F.silu(u @ lp["node_w1"] + lp["node_b1"])
    upd = upd @ lp["node_w2"] + lp["node_b2"]
    return _layer_norm(h + upd, lp["ln_node"])


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _gather_sharded(h, idx, mesh):
    """``h[idx]``: h (N, F) P(None, "model"), idx (E,) over the batch axes
    -> (E, F) P(ba, "model"); each rank gathers from its own columns (a
    plain gather of column-sharded rows would all-gather h over
    ``model``).  h's gradient: each rank's part, summed over the batch
    axes."""
    from repro_torch.distributed.sharding import P, axes_of, batch_axes, \
        entry_of, local_region, partial_over

    ba = entry_of(batch_axes(mesh))
    hs = P(None, "model")
    return local_region(lambda h_l, i_l: F.embedding(i_l, h_l), mesh,
                        (hs, P(ba)), (P(ba, "model"),),
                        (partial_over(hs, mesh, axes_of(ba)), None))(h, idx)


def _scatter_sum_sharded(m, dst, n: int, mesh):
    """Edge messages (E, F) over the batch axes (F over ``model`` where m
    is) scatter-added into n node rows: a local segment sum a rank, then
    one ``psum`` over the batch axes -> (N, F) P(None, F's axis)."""
    from repro_torch.distributed.collectives import psum
    from repro_torch.distributed.sharding import P, axes_of, batch_axes, \
        entry_of, local_region, sharded_axes

    ba = entry_of(batch_axes(mesh))
    f_ax = "model" if "model" in sharded_axes(m, 1) else None

    def local(m_l, dst_l):
        part = segment_sum(m_l, dst_l, n)
        for ax in axes_of(ba):
            part = psum(part, mesh.group(ax))
        return part

    return local_region(local, mesh, (P(ba, f_ax), P(ba)),
                        (P(None, f_ax),))(m, dst)


def _block(h, lp, src, dst, edge_mask, cfg: GNNConfig, mesh=None):
    n = h.shape[0]
    on_mesh = mesh is not None and _is_dtensor(h)
    if on_mesh and cfg.sharded_mp:
        m = _messages(_gather_sharded(h, src, mesh),
                      _gather_sharded(h, dst, mesh), lp, edge_mask)
    else:
        m = _messages(F.embedding(src, h), F.embedding(dst, h), lp,
                      edge_mask)
    if on_mesh and cfg.aggregator == "sum":
        agg = _scatter_sum_sharded(m, dst, n, mesh)
    elif cfg.aggregator == "sum":
        agg = segment_sum(m, dst, n)
    elif cfg.aggregator == "max":
        agg = segment_max(m, dst, n)
    else:
        raise ValueError(cfg.aggregator)
    return _update(h, agg, lp)


def _layer(proc: dict, li: int) -> dict:
    return {k: v[li] for k, v in proc.items()}


def forward(
    params: dict,
    node_feats: torch.Tensor,   # (N, d_feat)
    src: torch.Tensor,          # (E,) int
    dst: torch.Tensor,          # (E,) int
    cfg: GNNConfig,
    edge_mask: Optional[torch.Tensor] = None,   # (E,) bool for padded edges
    mesh=None,
) -> torch.Tensor:
    """Returns per-node predictions (N, n_vars)."""
    if mesh is not None and not _is_dtensor(node_feats):
        raise TypeError("forward(mesh=...) takes the global arrays as "
                        "DTensors (distributed/sharding.py distribute)")
    src, dst = src.long(), dst.long()
    hold = _node_hold(node_feats, mesh)
    h = hold(_mlp(node_feats.to(cfg.dtype), params["encoder"]))
    for li in range(cfg.n_layers):
        lp = _layer(params["proc"], li)
        if torch.is_grad_enabled():
            h = checkpoint(_block, h, lp, src, dst, edge_mask, cfg, mesh,
                           use_reentrant=False)
        else:
            h = _block(h, lp, src, dst, edge_mask, cfg, mesh)
        h = hold(h)
    return _mlp(h, params["decoder"])


def _node_hold(node_feats, mesh):
    """On a mesh, the node states held whole on every rank between blocks
    (the row-parallel products' partial sums reduced), their gradient too:
    DTensor's own plan splits the node rows over ``data`` with partial
    sums over ``model``, which the card's torch cannot carry into the
    next product."""
    if mesh is None or not _is_dtensor(node_feats):
        return lambda h: h
    from repro_torch.distributed.sharding import P, constrain

    return lambda h: constrain(h, P(None, None), mesh)


def forward_batched(params, node_feats, src, dst, cfg, edge_mask=None,
                    mesh=None):
    """(B, N, F) graphs with per-graph edge lists (B, E): each graph's node
    ids offset by b * N into one flat graph.  On a mesh (DTensors, the
    graphs split over the batch axes) each rank runs its graphs whole with
    the weights gathered (one region)."""
    if mesh is not None and _is_dtensor(node_feats):
        from repro_torch.distributed.sharding import P, entry_of, \
            local_region, partial_over, sharded_axes

        ba = sharded_axes(node_feats, 0)
        b_ = entry_of(ba)
        per_graph = (P(b_, None, None), P(b_, None), P(b_, None),
                     P(b_, None))
        return local_region(
            lambda p, nf, s_, d_, e_: forward_batched(p, nf, s_, d_, cfg, e_),
            mesh, (P(),) + per_graph, (P(b_, None, None),),
            (partial_over(P(), mesh, ba), None, None, None, None))(
                params, node_feats, src, dst, edge_mask)
    b, n = node_feats.shape[:2]
    off = (torch.arange(b, device=src.device) * n)[:, None]
    if edge_mask is None:
        edge_mask = torch.ones(src.shape, dtype=torch.bool,
                               device=src.device)
    out = forward(params, node_feats.reshape(b * n, -1),
                  (src.long() + off).reshape(-1),
                  (dst.long() + off).reshape(-1), cfg,
                  edge_mask.reshape(-1))
    return out.reshape(b, n, -1)


def forward_rowdp(params, node_feats, src, dst, cfg, mesh, edge_mask=None):
    """Row-DP message passing over all mesh axes flattened.

    Each rank passes its block: ``node_feats`` its rows (the rank's
    position in the flattened mesh times the row count is the first),
    ``src``/``dst``/``edge_mask`` its edges, which by the data pipeline's
    contract all have dst in its row range (edges sorted by dst).  The
    only collective is one tiled all-gather of the hidden rows a layer
    (a reduce-scatter of their gradient); the scatter is local.  Returns
    the rank's rows of predictions.  Given DTensors (the global arrays,
    replicated weights) it runs as the reference's ``shard_map``, the
    weights' gradients partial sums over every axis."""
    from repro_torch.distributed.sharding import P, local_region, \
        partial_over

    axes = tuple(mesh.axis_names)
    rows_spec, e_spec = P(axes, None), P(axes)
    if edge_mask is None and _is_dtensor(node_feats):
        edge_mask = torch.ones(src.shape, dtype=torch.bool,
                               device=src.device)
    return local_region(
        lambda nf, s_, d_, e_, p: _rowdp_local(p, nf, s_, d_, cfg, mesh, e_),
        mesh, (rows_spec, e_spec, e_spec, e_spec, P()), (rows_spec,),
        (None, None, None, None, partial_over(P(), mesh, axes)))(
            node_feats, src, dst, edge_mask, params)


def _rowdp_local(params, node_feats, src, dst, cfg, mesh, edge_mask):
    axes = tuple(mesh.axis_names)
    idx = 0
    for a in axes:
        idx = idx * mesh.size(a) + mesh.index(a)
    rows = node_feats.shape[0]
    lo = idx * rows
    src, dst = src.long(), dst.long()
    h_l = _mlp(node_feats.to(cfg.dtype), params["encoder"])   # (rows, dh)
    for li in range(cfg.n_layers):
        lp = _layer(params["proc"], li)
        if torch.is_grad_enabled():
            h_l = checkpoint(_rowdp_block, h_l, lp, src, dst, edge_mask,
                             mesh, axes, lo, use_reentrant=False)
        else:
            h_l = _rowdp_block(h_l, lp, src, dst, edge_mask, mesh, axes, lo)
    return _mlp(h_l, params["decoder"])


def _rowdp_block(h_l, lp, src, dst, edge_mask, mesh, axes, lo: int):
    from repro_torch.distributed.sharding import gather_axes

    rows = h_l.shape[0]
    h_full = gather_axes(h_l, mesh, axes)
    m = _messages(F.embedding(src, h_full), F.embedding(dst, h_full), lp,
                  edge_mask)
    # dst-sorted contract: every dst is in [lo, lo + rows)
    return _update(h_l, segment_sum(m, dst - lo, rows), lp)


def mse_loss(params, node_feats, src, dst, targets, cfg,
             edge_mask=None, node_mask=None, mesh=None) -> torch.Tensor:
    if cfg.row_dp and mesh is not None:
        pred = forward_rowdp(params, node_feats, src, dst, cfg, mesh,
                             edge_mask)
    else:
        pred = forward(params, node_feats, src, dst, cfg, edge_mask, mesh)
    err = (pred.float() - targets.float()) ** 2
    if node_mask is not None:
        err = torch.where(node_mask[:, None], err, 0.0)
        denom = torch.clamp_min(node_mask.sum() * err.shape[1], 1)
    else:
        denom = err.numel()
    return err.sum() / denom


def make_train_step(cfg: GNNConfig, opt_cfg=None, batched: bool = False,
                    mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds ``node_feats``, ``src``, ``dst``,
    ``targets`` and optionally ``edge_mask`` and ``node_mask``.  With a
    ``mesh`` every argument is a DTensor placed by the cell's specs
    (``row_dp``: ``forward_rowdp``; ``sharded_mp``: its gather and
    scatter regions; ``batched``: each rank's graphs)."""
    from repro_torch.optim import adamw

    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def loss(p, batch):
        if batched:
            pred = forward_batched(p, batch["node_feats"], batch["src"],
                                   batch["dst"], cfg,
                                   batch.get("edge_mask"), mesh)
            return torch.mean((pred.float()
                               - batch["targets"].float()) ** 2)
        return mse_loss(p, batch["node_feats"], batch["src"], batch["dst"],
                        batch["targets"], cfg, batch.get("edge_mask"),
                        batch.get("node_mask"), mesh)

    return adamw.make_step(loss, opt_cfg, mesh=mesh)
