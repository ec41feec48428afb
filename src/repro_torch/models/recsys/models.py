"""The four assigned recsys architectures (port of
``repro.models.recsys.models``).

* xDeepFM  [1803.05170]: linear + CIN (compressed interaction network,
  200-200-200) + DNN (400-400) over 39 sparse-feature embeddings (dim 10).
* Wide&Deep [1606.07792]: wide linear over sparse ids + deep MLP
  (1024-512-256) over 40 embeddings (dim 32).
* MIND     [1904.08030]: multi-interest network: behaviour sequence ->
  dynamic-routing capsules (4 interests, 3 iterations), label-aware
  attention at train, interest-vs-candidate max-dot at serve.
* DIN      [1706.06978]: target attention (att MLP 80-40, a sigmoid on
  every hidden layer) over a length-100 behaviour sequence, then MLP
  200-80.

Parameters are nested dicts of tensors, in the reference's tree (so
``ckpt/store.py`` names their files as the reference does).
``param_shapes`` gives them on the ``meta`` device.  ``forward(...,
mesh=...)`` runs on a :class:`repro_torch.launch.mesh.Mesh` with the
tables row-sharded over ``model`` (each rank passes its row blocks and its
batch block); ``make_train_step`` takes no mesh yet (ROADMAP item 4).

``retrieval_scores`` breaks ties lowest index first, as ``lax.top_k``
does (a stable sort, not ``torch.topk``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from .embedding import (
    embedding_bag,
    embedding_bag_sharded,
    embedding_lookup,
    embedding_lookup_sharded,
)

MESH_TRAIN_ERROR = ("make_train_step(mesh=...) is not ported yet (ROADMAP "
                    "item 4, with launch/cells.py): the gradient of the "
                    "sharded lookup's all-reduce needs a check of its own")


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str                 # xdeepfm | wide_deep | mind | din
    n_sparse: int             # sparse fields (ids per sample)
    embed_dim: int
    table_rows: int = 1 << 20
    mlp: tuple = ()
    cin_layers: tuple = ()    # xdeepfm
    attn_mlp: tuple = ()      # din
    seq_len: int = 0          # din/mind behaviour length
    n_interests: int = 0      # mind
    capsule_iters: int = 3    # mind
    dtype: Any = torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _mlp_shapes(dims: tuple, dtype) -> dict:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = _meta((a, b), dtype)
        out[f"b{i}"] = _meta((b,), dtype)
    return out


def _mlp_specs(dims: tuple) -> dict:
    from repro_torch.distributed.sharding import P

    out = {}
    for i in range(len(dims) - 1):
        out[f"w{i}"] = P()
        out[f"b{i}"] = P()
    return out


def _mlp_apply(x, mp, n, act=F.relu, last_act=False):
    for i in range(n):
        x = x @ mp[f"w{i}"] + mp[f"b{i}"]
        if i < n - 1 or last_act:
            x = act(x)
    return x


def param_shapes(cfg: RecSysConfig) -> dict:
    """The parameter tree as ``meta`` tensors (shapes and dtypes only)."""
    dt = cfg.dtype
    d = cfg.embed_dim
    sd = lambda s: _meta(s, dt)
    p: dict = {"table": sd((cfg.table_rows, d))}
    if cfg.kind == "xdeepfm":
        f = cfg.n_sparse
        p["linear"] = sd((cfg.table_rows, 1))
        cin = {}
        prev = f
        for i, hk in enumerate(cfg.cin_layers):
            cin[f"w{i}"] = sd((prev * f, hk))
            prev = hk
        p["cin"] = cin
        p["cin_out"] = sd((sum(cfg.cin_layers), 1))
        dnn_dims = (f * d,) + tuple(cfg.mlp) + (1,)
        p["dnn"] = _mlp_shapes(dnn_dims, dt)
    elif cfg.kind == "wide_deep":
        p["wide"] = sd((cfg.table_rows, 1))
        deep_dims = (cfg.n_sparse * d,) + tuple(cfg.mlp) + (1,)
        p["deep"] = _mlp_shapes(deep_dims, dt)
    elif cfg.kind == "din":
        att_dims = (4 * d,) + tuple(cfg.attn_mlp) + (1,)
        p["attn"] = _mlp_shapes(att_dims, dt)
        mlp_dims = ((cfg.n_sparse + 2) * d,) + tuple(cfg.mlp) + (1,)
        p["mlp"] = _mlp_shapes(mlp_dims, dt)
    elif cfg.kind == "mind":
        p["bilinear"] = sd((d, d))              # capsule routing bilinear map
        p["label_proj"] = sd((d, d))
    else:
        raise ValueError(cfg.kind)
    return p


def param_specs(cfg: RecSysConfig) -> dict:
    from repro_torch.distributed.sharding import P, recsys_table_spec

    p: dict = {"table": recsys_table_spec()}
    if cfg.kind == "xdeepfm":
        p["linear"] = recsys_table_spec()
        p["cin"] = {f"w{i}": P() for i in range(len(cfg.cin_layers))}
        p["cin_out"] = P()
        p["dnn"] = _mlp_specs((cfg.n_sparse * cfg.embed_dim,)
                              + tuple(cfg.mlp) + (1,))
    elif cfg.kind == "wide_deep":
        p["wide"] = recsys_table_spec()
        p["deep"] = _mlp_specs((cfg.n_sparse * cfg.embed_dim,)
                               + tuple(cfg.mlp) + (1,))
    elif cfg.kind == "din":
        p["attn"] = _mlp_specs((4 * cfg.embed_dim,) + tuple(cfg.attn_mlp)
                               + (1,))
        p["mlp"] = _mlp_specs(((cfg.n_sparse + 2) * cfg.embed_dim,)
                              + tuple(cfg.mlp) + (1,))
    elif cfg.kind == "mind":
        p["bilinear"] = P()
        p["label_proj"] = P()
    return p


def init_params(cfg: RecSysConfig, generator: torch.Generator,
                device=None) -> dict:
    """Standard normals drawn from ``generator`` (on its device) in the
    tree's leaf order, scaled as the reference scales them: 0.05 for a
    leaf of rank < 2, else 1/sqrt(shape[-2]); then moved to ``device``
    (default: the generator's)."""
    from repro_torch.distributed.collectives import tree_map

    gdev = generator.device
    dev = torch.device(device) if device is not None else gdev

    def draw(s: torch.Tensor) -> torch.Tensor:
        scale = 0.05 if s.dim() < 2 else 1.0 / math.sqrt(s.shape[-2])
        x = torch.randn(s.shape, generator=generator, dtype=s.dtype,
                        device=gdev) * scale
        return x.to(dev)

    return tree_map(draw, param_shapes(cfg))


# --------------------------------------------------------------------------
# forwards (mesh=None -> one device; mesh -> row-sharded tables)
# --------------------------------------------------------------------------
def _lookup(table, ids, mesh, batch_axes):
    if mesh is None:
        return embedding_lookup(table, ids)
    return embedding_lookup_sharded(table, ids, mesh, batch_axes)


def _bag(table, ids, mesh, batch_axes, weights=None):
    if mesh is None:
        return embedding_bag(table, ids, weights)
    return embedding_bag_sharded(table, ids, mesh, weights, batch_axes)


def _cin(x0: torch.Tensor, params: dict, cfg: RecSysConfig) -> torch.Tensor:
    """Compressed Interaction Network.  x0: (B, F, D)."""
    b, f, d = x0.shape
    xk = x0
    outs = []
    for i, hk in enumerate(cfg.cin_layers):
        # outer interaction: (B, Hk-1, F, D)
        z = torch.einsum("bhd,bfd->bhfd", xk, x0)
        z = z.reshape(b, xk.shape[1] * f, d)
        xk = torch.einsum("bzd,zh->bhd", z, params["cin"][f"w{i}"])
        xk = F.relu(xk)                                       # (B, Hk, D)
        outs.append(xk.sum(dim=2))                            # (B, Hk)
    return torch.cat(outs, dim=1)                             # (B, sum Hk)


def forward(params: dict, batch: dict, cfg: RecSysConfig, mesh=None,
            batch_axes: tuple = ("data",)) -> torch.Tensor:
    """Returns logits (B,)."""
    ids = batch["sparse_ids"]                       # (B, F)
    b = ids.shape[0]
    if cfg.kind == "xdeepfm":
        emb = _lookup(params["table"], ids, mesh, batch_axes)      # (B, F, D)
        lin = _bag(params["linear"], ids, mesh, batch_axes)[:, 0]  # (B,)
        cin_feats = _cin(emb, params, cfg)
        cin_term = (cin_feats @ params["cin_out"])[:, 0]
        dnn_in = emb.reshape(b, -1)
        n_mlp = len(cfg.mlp) + 1
        dnn_term = _mlp_apply(dnn_in, params["dnn"], n_mlp)[:, 0]
        return lin + cin_term + dnn_term
    if cfg.kind == "wide_deep":
        wide = _bag(params["wide"], ids, mesh, batch_axes)[:, 0]
        emb = _lookup(params["table"], ids, mesh, batch_axes)
        deep = _mlp_apply(emb.reshape(b, -1), params["deep"],
                          len(cfg.mlp) + 1)[:, 0]
        return wide + deep
    if cfg.kind == "din":
        emb = _lookup(params["table"], ids, mesh, batch_axes)      # (B, F, D)
        target = emb[:, 0]                                         # target item
        hist = _lookup(params["table"], batch["hist_ids"], mesh,
                       batch_axes)                                 # (B, S, D)
        hmask = (torch.arange(cfg.seq_len, device=ids.device)[None, :]
                 < batch["hist_len"][:, None])
        t = torch.broadcast_to(target[:, None, :], hist.shape)
        att_in = torch.cat([hist, t, hist - t, hist * t], dim=-1)
        score = _mlp_apply(att_in, params["attn"], len(cfg.attn_mlp) + 1,
                           act=torch.sigmoid)[..., 0]              # (B, S)
        score = torch.where(hmask, score, 0.0)
        interest = torch.einsum("bs,bsd->bd", score, hist)
        x = torch.cat([emb.reshape(b, -1), interest, interest * target],
                      dim=-1)
        return _mlp_apply(x, params["mlp"], len(cfg.mlp) + 1)[:, 0]
    if cfg.kind == "mind":
        hist = _lookup(params["table"], batch["hist_ids"], mesh, batch_axes)
        hmask = (torch.arange(cfg.seq_len, device=ids.device)[None, :]
                 < batch["hist_len"][:, None])
        interests = capsule_routing(hist, hmask, params["bilinear"], cfg)
        target = _lookup(params["table"], batch["sparse_ids"][:, :1], mesh,
                         batch_axes)[:, 0]
        lbl = target @ params["label_proj"]
        att = torch.softmax(
            torch.einsum("bid,bd->bi", interests, lbl)
            * math.sqrt(1.0 * cfg.embed_dim), dim=-1)
        user = torch.einsum("bi,bid->bd", att, interests)
        return torch.einsum("bd,bd->b", user, target)
    raise ValueError(cfg.kind)


def capsule_routing(hist: torch.Tensor,       # (B, S, D)
                    mask: torch.Tensor,       # (B, S) bool
                    bilinear: torch.Tensor,   # (D, D)
                    cfg: RecSysConfig) -> torch.Tensor:
    """B2I dynamic routing (MIND §4.2): behaviour capsules -> interest
    capsules (B, I, D).  The gradient flows through every routing
    iteration, as through the reference's ``lax.scan``."""
    b, s, d = hist.shape
    u = hist @ bilinear                                    # (B, S, D)
    logits = torch.zeros((b, cfg.n_interests, s), dtype=torch.float32,
                         device=hist.device)

    def squash(v):
        n2 = torch.sum(v * v, dim=-1, keepdim=True)
        return (n2 / (1 + n2)) * v * torch.rsqrt(n2 + 1e-9)

    v = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=1)                   # over interests
        w = torch.where(mask[:, None, :], w, 0.0)
        z = torch.einsum("bis,bsd->bid", w, u)
        v = squash(z)
        logits = logits + torch.einsum("bid,bsd->bis", v, u)
    return v


def bce_loss(params, batch, cfg, mesh=None, batch_axes=("data",)
             ) -> torch.Tensor:
    logits = forward(params, batch, cfg, mesh, batch_axes)
    y = batch["labels"]
    logp = F.logsigmoid(logits)
    lognp = F.logsigmoid(-logits)
    return -torch.mean(y * logp + (1 - y) * lognp)


def make_train_step(cfg: RecSysConfig, opt_cfg=None, mesh=None,
                    batch_axes=("data",)):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradient by autograd, then
    :func:`repro_torch.optim.adamw.apply` (default ``weight_decay`` 0)."""
    from repro_torch.distributed.collectives import tree_flatten, \
        tree_unflatten
    from repro_torch.optim import adamw

    if mesh is not None:
        raise NotImplementedError(MESH_TRAIN_ERROR)
    opt_cfg = opt_cfg or adamw.AdamWConfig(weight_decay=0.0)

    def train_step(params, opt_state, batch):
        leaves, structure = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = bce_loss(tree_unflatten(structure, live), batch, cfg)
            grads = torch.autograd.grad(loss, live)
        params, opt_state, metrics = adamw.apply(
            params, tree_unflatten(structure, list(grads)), opt_state,
            opt_cfg)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def retrieval_scores(user: torch.Tensor,        # (B, D) or (B, I, D)
                     candidates: torch.Tensor,  # (N, D)
                     k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """Score every candidate; return the top-k (scores, ids), ties lowest
    index first.  Multi-interest users take the max over interests per
    candidate (MIND serving)."""
    if user.dim() == 2:
        scores = user @ candidates.T                    # (B, N)
    else:
        scores = torch.einsum("bid,nd->bin", user, candidates).amax(dim=1)
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)
