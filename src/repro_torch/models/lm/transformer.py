"""Decoder-only transformer family covering the five assigned LM archs
(port of ``repro.models.lm.transformer``).

Features (per the assigned configs):
* GQA attention (separate n_kv), RoPE (half-split), RMSNorm, SwiGLU MLP.
* gemma3-style hybrid attention: blocks of ``period`` layers where the last
  layer is global and the rest use a sliding window (5:1 local:global).
* MoE layers (llama4-scout top-1 x16; qwen2-moe 4 shared + 60 routed
  top-4) with expert parallelism over a mesh (``models/lm/moe.py``).
* a loop over stacked blocks; ``torch.utils.checkpoint`` (remat) per block
  and over the tail group when gradients are on.
* chunked attention and a chunked loss, so a 32k-token prefill never
  materializes an (S, S) score matrix or a full (B, S, V) logit tensor.
* a decode path with stacked KV caches: global layers cache the full
  context, local layers only their window (a ring buffer), which is what
  makes ``long_500k`` sub-quadratic in memory for the hybrid archs.

Parameters are nested dicts of tensors in the reference's tree: ``layers``
stacked (n_blocks, period, ...), ``tail`` (tail_local, ...).
``param_shapes`` gives them on the ``meta`` device; ``param_specs`` the
reference's partition specs (:class:`repro_torch.distributed.sharding.P`).

Numerics follow the reference: attention scores and probabilities in
float32 over the whole key range (plain ``einsum`` and ``softmax``: no
fused attention, whose bf16 arithmetic and masking differ), RMSNorm and
the rotary angles in float32, the embedding scale and the residual stream
in the model's dtype, the logits rounded to it before the float32 loss.

On a :class:`repro_torch.launch.mesh.Mesh` the functions take either
form of the reference's arrays:

* local view (plain tensors, each rank's batch block): ``forward`` runs
  the dense layers whole on each rank and the MoE layers with expert
  parallelism;
* global view (DTensors placed by ``param_specs``, as
  ``make_train_step(mesh=...)``, ``prefill_step`` and ``decode_step``
  take them from ``launch/cells.py``): DTensor partitions the plain code
  (Megatron TP over ``model`` in the three head regimes, ``fsdp``'s and
  ``pure_dp``'s weight layouts, ``seq_parallel`` as the residual
  stream's spec), the residual stream is held to its spec after each
  sub-layer (its gradient too, as ``with_sharding_constraint`` holds
  it), and ``local_map`` regions run where DTensor's own rules would
  replicate or break: the vocab-sharded lookup and cross-entropy, the
  attention core of the head and Dh regimes, the Dh-sharded projections,
  the MoE expert-parallel body and the split-KV cache writes (module
  section "the mesh").
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import axes_of, entry_of

from .moe import MoEConfig, moe_ffn, moe_param_shapes, moe_param_specs

@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    window: int = 0                 # sliding window size for local layers
    period: int = 1                 # layers per block; last layer of a block
                                    # is global, the rest local (gemma3: 6)
    moe: Optional[MoEConfig] = None
    dtype: Any = torch.bfloat16
    q_chunk: int = 1024             # query-chunk for attention & loss
    fsdp: bool = False              # ZeRO-3 weight sharding over `data`
    tail_local: int = 0             # extra local-only layers after the blocks
                                    # (gemma3-27b: 62 = 10x6 + 2 local)
    remat: bool = True
    pad_heads_to: int = 0           # perf: pad H up so heads shard over TP=16
    pure_dp: bool = False           # perf: no TP, ZeRO-3 over data x model
    seq_parallel: bool = False      # perf: Megatron-SP between blocks

    @property
    def heads_padded(self) -> int:
        return max(self.pad_heads_to, self.n_heads)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_blocks(self) -> int:
        main = self.n_layers - self.tail_local
        assert main % self.period == 0, (self.n_layers, self.period)
        return main // self.period

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6ND roofline accounting)."""
        d, h, kv, dh, f = (
            self.d_model, self.n_heads, self.n_kv, self.head_dim, self.d_ff,
        )
        attn = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        if self.moe is None:
            ffn = 3 * d * f
        else:
            m = self.moe
            ffn = (m.n_experts * 3 * d * m.d_ff_expert
                   + m.n_shared * 3 * d * m.d_ff_shared)
            ffn += d * m.n_experts  # router
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + self.vocab * d + d

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if self.moe is None:
            return self.n_params
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv, self.head_dim
        m = self.moe
        attn = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        ffn = (m.top_k * 3 * d * m.d_ff_expert
               + m.n_shared * 3 * d * m.d_ff_shared)
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + self.vocab * d + d


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _group_shapes(cfg: LMConfig, lead: tuple) -> dict:
    d, h, kv, dh, f = (
        cfg.d_model, cfg.heads_padded, cfg.n_kv, cfg.head_dim, cfg.d_ff,
    )
    sd = lambda shape: _meta(lead + shape, cfg.dtype)
    layers = {
        "wq": sd((d, h, dh)),
        "wk": sd((d, kv, dh)),
        "wv": sd((d, kv, dh)),
        "wo": sd((h, dh, d)),
        "rms1": sd((d,)),
        "rms2": sd((d,)),
    }
    if cfg.moe is None:
        layers.update({
            "w_gate": sd((d, f)),
            "w_up": sd((d, f)),
            "w_down": sd((f, d)),
        })
    else:
        layers.update(moe_param_shapes(cfg.moe, d, lead, cfg.dtype))
    return layers


def param_shapes(cfg: LMConfig) -> dict:
    """The parameter tree as ``meta`` tensors (shapes and dtypes only)."""
    sd = lambda shape: _meta(shape, cfg.dtype)
    out = {
        "embed": sd((cfg.vocab, cfg.d_model)),
        "final_norm": sd((cfg.d_model,)),
        "layers": _group_shapes(cfg, (cfg.n_blocks, cfg.period)),
    }
    if cfg.tail_local:
        out["tail"] = _group_shapes(cfg, (cfg.tail_local,))
    return out


def param_specs(cfg: LMConfig, tp: int = 16, fsdp: Optional[bool] = None
                ) -> dict:
    """Partition specs matching ``param_shapes`` (Megatron TP over
    ``model``), by the reference's rules: heads sharded when H % tp == 0
    (KV heads too when KV % tp == 0), else head_dim when Dh % tp == 0,
    else replicated; ``fsdp`` also shards the big FFN and expert weights
    over ``data``."""
    from repro_torch.distributed.sharding import P

    if fsdp is None:
        fsdp = cfg.fsdp
    if cfg.pure_dp:
        return _pure_dp_specs(cfg, tp)
    dp = "data" if fsdp else None
    h, kv, dh = cfg.heads_padded, cfg.n_kv, cfg.head_dim

    def group(n_lead: int) -> dict:
        lead = (None,) * n_lead
        if h % tp == 0:
            wq = P(*lead, None, "model", None)
            wo = P(*lead, "model", None, None)
            if kv % tp == 0:
                wk = wv = P(*lead, None, "model", None)
            else:
                wk = wv = P(*lead, None, None, None)
        elif dh % tp == 0:
            wq = wk = wv = P(*lead, None, None, "model")
            wo = P(*lead, None, "model", None)
        else:
            wq = wk = wv = P(*lead, None, None, None)
            wo = P(*lead, None, None, None)
        layers = {
            "wq": wq, "wk": wk, "wv": wv, "wo": wo,
            "rms1": P(), "rms2": P(),
        }
        if cfg.moe is None:
            layers.update({
                "w_gate": P(*lead, dp, "model"),
                "w_up": P(*lead, dp, "model"),
                "w_down": P(*lead, "model", dp),
            })
        else:
            layers.update(moe_param_specs(cfg.moe, fsdp, n_lead))
        return layers

    out = {
        "embed": P("model", None),
        "final_norm": P(),
        "layers": group(2),
    }
    if cfg.tail_local:
        out["tail"] = group(1)
    return out


def _pure_dp_specs(cfg: LMConfig, tp: int, dsize: int = 16) -> dict:
    """ZeRO-3 layout: every weight sharded on its first dim divisible by
    data x model over both axes (else by model over ``model``, else
    replicated)."""
    from repro_torch.distributed.collectives import tree_map
    from repro_torch.distributed.sharding import P

    both = dsize * tp

    def spec_of(t: torch.Tensor):
        shp = tuple(t.shape)
        for i, d in enumerate(shp):
            if d % both == 0:
                return P(*([None] * i), ("data", "model"),
                         *([None] * (len(shp) - i - 1)))
        for i, d in enumerate(shp):
            if d % tp == 0:
                return P(*([None] * i), "model",
                         *([None] * (len(shp) - i - 1)))
        return P()

    return tree_map(spec_of, param_shapes(cfg))


_LEAD = {"layers": 2, "tail": 1}            # stacked dims of each group
_ONES = ("rms1", "rms2", "final_norm")


def init_params(cfg: LMConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's rule: a leaf of rank >= 2 with a last dim above 1
    is normal / sqrt(shape[-2]) (its stacked dims counted, as the
    reference counts them), any other leaf and the norms are ones.

    Standard normals are drawn from ``generator`` (on its device) in the
    tree's leaf order, one layer slice of a stacked leaf at a time, in
    float32, scaled, then cast into the leaf on ``device`` (default: the
    generator's): a float32 draw of a whole stacked leaf would not fit
    beside the weights of the largest archs."""
    from repro_torch.distributed.collectives import tree_flatten_with_path, \
        tree_unflatten, tree_flatten

    gdev = generator.device
    dev = torch.device(device) if device is not None else gdev
    shapes = param_shapes(cfg)
    leaves = []
    for path, s in tree_flatten_with_path(shapes):
        out = torch.empty(s.shape, dtype=s.dtype, device=dev)
        if path[-1] in _ONES or not (s.dim() >= 2 and s.shape[-1] > 1):
            leaves.append(out.fill_(1))
            continue
        fan_in = math.sqrt(max(s.shape[-2], 1))
        n_lead = _LEAD.get(path[0], 0)
        for idx in itertools.product(*(range(n) for n in s.shape[:n_lead])):
            x = torch.randn(s.shape[n_lead:], generator=generator,
                            dtype=torch.float32, device=gdev)
            out[idx] = (x / fan_in).to(dev)
        leaves.append(out)
    return tree_unflatten(tree_flatten(shapes)[1], leaves)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh), pos: (T,) or (..., T) absolute positions; the
    half-split rotation (first half with the second), in float32."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].to(torch.float32) * freqs          # (..., T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attend(
    q: torch.Tensor,        # (B, Tq, H, Dh) rotated
    k: torch.Tensor,        # (B, Tk, KV, Dh) rotated
    v: torch.Tensor,        # (B, Tk, KV, Dh)
    qpos: torch.Tensor,     # (Tq,)
    kpos: torch.Tensor,     # (Tk,) (or (B, Tk) for ring buffers)
    kvalid: torch.Tensor,   # (Tk,) or (B, Tk) bool
    window: int,            # 0 = global
    dh_group=None,          # the Dh-sharded region's group (module doc)
    d_head: int = 0,        # the whole head dim there (0: q's)
) -> torch.Tensor:
    b, tq, h, dh = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, tq, kvh, rep, dh)        # head h = kv * rep + r
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), k.float())
    if dh_group is not None:
        from repro_torch.distributed.collectives import psum

        scores = psum(scores, dh_group)     # partial over the Dh blocks
    scores = scores / math.sqrt(d_head or dh)
    if kpos.dim() == 1:
        kp, kv_ok = kpos[None, :], kvalid[None, :]
    else:
        kp, kv_ok = kpos, kvalid
    causal = qpos[None, :, None] >= kp[:, None, :]          # (B, Tq, Tk)
    mask = causal & kv_ok[:, None, :]
    if window > 0:
        mask = mask & ((qpos[None, :, None] - kp[:, None, :]) < window)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if dh_group is not None:
        from repro_torch.distributed.collectives import copy_to

        # each rank's values are a Dh block: its part of probs' gradient
        probs = copy_to(probs, dh_group)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v.float())
    return out.reshape(b, tq, h, dh).to(q.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk")."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], w.shape[1], w.shape[2])


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    return o.reshape(*o.shape[:-2], -1) @ w.reshape(-1, w.shape[-1])


def attention_full(x: torch.Tensor, lp: dict, pos0: int, window: int,
                   cfg: LMConfig, *, return_kv: bool = False, mesh=None):
    """Training/prefill attention over query chunks of ``cfg.q_chunk``
    (one chunk when the sequence does not divide)."""
    b, s, d = x.shape
    q = _proj_any(x, lp["wq"], mesh)
    k = _proj_any(x, lp["wk"], mesh)
    v = _proj_any(x, lp["wv"], mesh)
    pos = pos0 + torch.arange(s, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    qc = min(cfg.q_chunk, s)
    if s % qc:
        qc = s  # fall back to unchunked for ragged small shapes
    kvalid = torch.ones((s,), dtype=torch.bool, device=x.device)
    o = torch.cat([
        _attend_any(q[:, i:i + qc], k, v, pos[i:i + qc], pos, kvalid,
                    window, lp, mesh)
        for i in range(0, s, qc)], dim=1)
    out = _out_any(o, lp["wo"], mesh)
    if return_kv:
        return out, k, v
    return out


def swiglu(x: torch.Tensor, lp: dict) -> torch.Tensor:
    g = x @ lp["w_gate"]
    u = x @ lp["w_up"]
    return (F.silu(g.float()).to(x.dtype) * u) @ lp["w_down"]


def _ffn(x: torch.Tensor, lp: dict, cfg: LMConfig, mesh) -> torch.Tensor:
    if cfg.moe is None:
        return swiglu(x, lp)
    return moe_ffn(x, lp, cfg.moe, mesh, cfg.fsdp)


def _layer(gp: dict, li) -> dict:
    return {k: v[li] for k, v in gp.items()}


def group_forward(x: torch.Tensor, gp: dict, cfg: LMConfig, pos0: int,
                  mesh=None, *, n_in_group: int, all_local: bool = False,
                  res=None) -> torch.Tensor:
    """Run ``n_in_group`` stacked layers.  Unless ``all_local``, the last
    layer of the group is global and the rest use the sliding window.
    On a mesh, ``res`` is the residual stream's spec (:func:`_res_spec`),
    held after each sub-layer."""
    for li in range(n_in_group):
        lp = _layer(gp, li)
        if cfg.pure_dp and res is not None:
            # ZeRO-3: one all-gather of each weight a layer
            lp = {k: _replicated(w) for k, w in lp.items()}
        is_global = (li == n_in_group - 1) and not all_local
        window = 0 if (is_global or cfg.window == 0) else cfg.window
        h = rms_norm(x, lp["rms1"])
        x = _hold(x + attention_full(h, lp, pos0, window, cfg, mesh=mesh),
                  res, mesh)
        h = rms_norm(x, lp["rms2"])
        x = _hold(x + _ffn(h, lp, cfg, mesh), res, mesh)
    return x


def block_forward(x: torch.Tensor, bp: dict, cfg: LMConfig, pos0: int,
                  mesh=None, res=None) -> torch.Tensor:
    """One block = ``period`` layers; layers [0..period-2] local, last
    global."""
    return group_forward(x, bp, cfg, pos0, mesh, n_in_group=cfg.period,
                         res=res)


def _embed(params: dict, tokens: torch.Tensor, cfg: LMConfig, mesh=None
           ) -> torch.Tensor:
    """The embedding rows times sqrt(d_model), in the model's dtype (the
    scale rounded to it first, as a weakly typed scalar is in JAX).  On a
    mesh (DTensors) the rows come from the sharded lookup over the
    vocab-sharded table (``recsys/embedding.py``), the tokens' batch split
    as they come, never over ``model``."""
    table = params["embed"].to(cfg.dtype)
    if mesh is not None and is_dtensor(table):
        from repro_torch.distributed.sharding import sharded_axes
        from repro_torch.models.recsys.embedding import \
            embedding_lookup_sharded

        ba = tuple(a for a in sharded_axes(tokens, 0) if a != "model")
        x = embedding_lookup_sharded(table, tokens, mesh, ba)
    else:
        x = F.embedding(tokens.long(), table)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                            device=x.device)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _remat(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig, mesh=None
            ) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D)."""
    res = _res_spec(tokens, cfg, mesh)
    x = _hold(_embed(params, tokens, cfg, mesh), res, mesh)
    run = _remat if cfg.remat else (lambda fn, *a: fn(*a))
    for bi in range(cfg.n_blocks):
        x = run(block_forward, x, _layer(params["layers"], bi), cfg, 0, mesh,
                res)
    if cfg.tail_local:
        def tail_fn(x, gp):
            return group_forward(x, gp, cfg, 0, mesh,
                                 n_in_group=cfg.tail_local, all_local=True,
                                 res=res)
        x = run(tail_fn, x, params["tail"])
    return _hold(rms_norm(x, params["final_norm"]), res, mesh)


def _chunk_loss(hc: torch.Tensor, w: torch.Tensor, tc: torch.Tensor
                ) -> torch.Tensor:
    logits = (hc @ w.T).float()
    logz = torch.logsumexp(logits, dim=-1)
    # gold logit via mask + sum, as the reference computes it
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(vocab_ids == tc[..., None], logits, 0.0),
                     dim=-1)
    return torch.sum(logz - gold)


def chunked_ce_loss(h: torch.Tensor, embed: torch.Tensor,
                    targets: torch.Tensor, cfg: LMConfig, mesh=None
                    ) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V): over S-chunks (each
    recomputed in the backward when ``cfg.remat``)."""
    b, s, d = h.shape
    qc = min(cfg.q_chunk, s)
    if s % qc:
        qc = s
    w = embed.to(cfg.dtype)
    sharded = is_dtensor(h)
    # on a mesh each rank's chunk logits are (B / dp, qc, V / tp): kept for
    # the backward, as the reference keeps its chunks' (no remat there)
    run = _remat if cfg.remat and not sharded else (lambda fn, *a: fn(*a))
    chunk = _chunk_loss_sharded(mesh) if sharded else _chunk_loss
    parts = [run(chunk, h[:, i:i + qc], w, targets[:, i:i + qc])
             for i in range(0, s, qc)]
    tot = parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))
    return tot / (b * s)


# ---------------------------------------------------------------------------
# the mesh (global view): DTensor placements, and local_map regions where
# DTensor's own rules would replicate or break
# ---------------------------------------------------------------------------
def _res_spec(tokens, cfg: LMConfig, mesh):
    """The residual stream's spec: the tokens' batch split (both axes for
    ``pure_dp``), the sequence over ``model`` with ``seq_parallel`` (the
    reference's ``_sp_constraint``); None off a mesh."""
    if mesh is None or not is_dtensor(tokens):
        return None
    from repro_torch.distributed.sharding import P, sharded_axes

    b = entry_of(sharded_axes(tokens, 0))
    return P(b, "model", None) if cfg.seq_parallel else P(b, None, None)


def _hold(x, res, mesh):
    """``x`` held to the residual spec, its gradient too (the reference's
    ``with_sharding_constraint``)."""
    if res is None:
        return x
    from repro_torch.distributed.sharding import constrain

    return constrain(x, res, mesh)


def _replicated(w):
    from torch.distributed.tensor import Replicate

    return w.redistribute(w.device_mesh,
                          [Replicate()] * w.device_mesh.ndim)


def _model_dim(t):
    """The tensor dim that ``t`` splits over ``model``, or None."""
    from torch.distributed.tensor import Shard

    names = t.device_mesh.mesh_dim_names
    p = t.placements[names.index("model")]
    return p.dim if isinstance(p, Shard) else None


def _attend_any(q, k, v, qpos, kpos, kvalid, window, lp, mesh):
    """:func:`_attend`, on a mesh through the region its layout needs:

    * a cache with its sequence over ``model`` (split-KV decode): the
      query's heads gathered (one token), then DTensor's rules (the
      scores' softmax gathers them, the values' product sums over
      ``model``);
    * heads over ``model``: each rank attends with its heads and the KV
      heads they read (``local_map``; DTensor cannot split the sharded
      head dim into (KV, rep));
    * ``Dh`` over ``model`` (phi4-mini, llama4-scout): the scores are
      partial sums over ``Dh``, summed over ``model`` (the reference's
      O(S^2) score psum), in a ``local_map``;
    * replicated heads: DTensor's rules."""
    if mesh is None or not is_dtensor(q):
        return _attend(q, k, v, qpos, kpos, kvalid, window)
    from repro_torch.distributed.sharding import P, local_region, \
        partial_over, sharded_axes

    b = entry_of(sharded_axes(q, 0))
    if _model_dim(k) == 1:                       # split-KV cache
        q = _replicated_over_model(q, b, mesh)
        return _attend(q, k, v, qpos, kpos, kvalid, window)
    w_dim = _model_dim(lp["wq"])
    if w_dim == 1:                               # heads over model
        h, kvh = q.shape[2], k.shape[2]
        kv_split = _model_dim(k) == 2
        qs = P(b, None, "model", None)
        ks = qs if kv_split else P(b, None, None, None)

        def local(q, k, v):
            if not kv_split:
                hl, rp = q.shape[2], h // kvh
                h0 = mesh.index("model") * hl
                if (hl % rp and rp % hl) or h0 % min(hl, rp):
                    raise ValueError(f"{hl} local heads do not align with "
                                     f"{rp} heads a KV head")
                lo, hi = h0 // rp, (h0 + hl - 1) // rp + 1
                k, v = k[:, :, lo:hi], v[:, :, lo:hi]
            return _attend(q, k, v, qpos, kpos, kvalid, window)

        gk = None if kv_split else partial_over(ks, mesh, ("model",))
        return local_region(local, mesh, (qs, ks, ks), (qs,),
                            (None, gk, gk))(q, k, v)
    if w_dim == 2:                               # Dh over model
        spec = P(b, None, None, "model")
        d_head = q.shape[-1]
        group = mesh.group("model")

        def local(q, k, v):
            return _attend(q, k, v, qpos, kpos, kvalid, window,
                           dh_group=group, d_head=d_head)

        return local_region(local, mesh, (spec, spec, spec), (spec,))(
            q, k, v)
    return _attend(q, k, v, qpos, kpos, kvalid, window)


def _proj_any(x, w, mesh):
    """:func:`_proj`; with ``w``'s Dh over ``model``, a ``local_map`` of
    the rank's Dh columns (DTensor's rule for the flattened (H, Dh) would
    be a strided shard, whose matmul strategy search takes minutes on
    the three-axis mesh)."""
    if mesh is None or not is_dtensor(w) or _model_dim(w) != 2:
        return _proj(x, w)
    from repro_torch.distributed.collectives import copy_to
    from repro_torch.distributed.sharding import P, local_region, \
        partial_over, sharded_axes

    bax = sharded_axes(x, 0)
    b = entry_of(bax)
    group = mesh.group("model")
    ws = P(None, None, "model")
    return local_region(lambda x, w: _proj(copy_to(x, group), w), mesh,
                        (P(b, None, None), ws), (P(b, None, None, "model"),),
                        (None, partial_over(ws, mesh, bax)))(x, w)


def _out_any(o, w, mesh):
    """:func:`_out`; with ``w``'s Dh over ``model``, each rank's Dh block
    of the product, ``psum``'d (a ``local_map``, as :func:`_proj_any`)."""
    if mesh is None or not is_dtensor(w) or _model_dim(w) != 1:
        return _out(o, w)
    from repro_torch.distributed.collectives import psum
    from repro_torch.distributed.sharding import P, local_region, \
        partial_over, sharded_axes

    bax = sharded_axes(o, 0)
    b = entry_of(bax)
    group = mesh.group("model")
    ws = P(None, "model", None)
    return local_region(lambda o, w: psum(_out(o, w), group), mesh,
                        (P(b, None, None, "model"), ws), (P(b, None, None),),
                        (None, partial_over(ws, mesh, bax)))(o, w)


def _replicated_over_model(t, b, mesh):
    from repro_torch.distributed.sharding import P, constrain

    return constrain(t, P(b, *([None] * (t.dim() - 1))), mesh)


def _cache_write(c, new, slot: int, mesh):
    """``c[:, slot] = new`` in place; on a mesh, the rank whose block of
    the cache's sequence holds ``slot`` writes it (``local_map``: an index
    into a sharded dim has no in-place DTensor rule)."""
    if mesh is None or not is_dtensor(c):
        c[:, slot] = new
        return c
    from repro_torch.distributed.sharding import P, local_region, \
        sharded_axes

    seq_axes = sharded_axes(c, 1)
    b = entry_of(sharded_axes(c, 0))
    cspec = P(b, entry_of(seq_axes), None, None)

    def local(c, new):
        idx = 0
        for a in seq_axes:
            idx = idx * mesh.size(a) + mesh.index(a)
        lo = idx * c.shape[1]
        if lo <= slot < lo + c.shape[1]:
            c[:, slot - lo] = new
        return c

    return local_region(local, mesh, (cspec, P(b, None, None)), (cspec,))(
        c, new)


def _chunk_loss_sharded(mesh):
    """:func:`_chunk_loss` over the vocab-sharded embedding (Megatron's
    vocab-parallel cross-entropy, in a ``local_map``): each rank's logits
    over its vocab rows, the log-sum-exp from the ranks' maxima and
    ``psum``'d exponent sums, the gold logit ``psum``'d; the result this
    rank's batch block's sum, a partial sum over the batch axes.
    DTensor's own log-sum-exp over a sharded vocab gathers the whole
    (B, S, V) logits."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.distributed.collectives import all_gather_cat, \
        copy_to, psum
    from repro_torch.distributed.sharding import P, local_region, \
        partial_over

    group = mesh.group("model")
    batch = tuple(a for a in mesh.axis_names if a != "model")

    def local(hc, w, tc):
        hc = copy_to(hc, group)
        logits = (hc @ w.T).float()                   # (B, S, V / tp)
        m = all_gather_cat(torch.amax(logits, dim=-1, keepdim=True).detach(),
                           group, dim=-1).amax(dim=-1, keepdim=True)
        se = psum(torch.sum(torch.exp(logits - m), dim=-1), group)
        logz = m[..., 0] + torch.log(se)
        lo = mesh.index("model") * w.shape[0]
        vocab_ids = lo + torch.arange(w.shape[0], device=logits.device)
        gold = psum(torch.sum(torch.where(vocab_ids == tc[..., None],
                                          logits, 0.0), dim=-1), group)
        return torch.sum(logz - gold)

    def chunk(hc, w, tc):
        from repro_torch.distributed.sharding import sharded_axes

        b = entry_of(tuple(a for a in sharded_axes(hc, 0) if a != "model"))
        hs, ts, ws = P(b, None, None), P(b, None), P("model", None)
        out = [Partial() if a in axes_of(b) else Replicate()
               for a in mesh.axis_names]
        gw = partial_over(ws, mesh, batch)
        return local_region(local, mesh, (hs, ws, ts), (out,),
                            (None, gw, None))(hc, w, tc)

    return chunk


# ---------------------------------------------------------------------------
# train / prefill / decode steps
# ---------------------------------------------------------------------------
def loss_fn(params: dict, tokens: torch.Tensor, cfg: LMConfig, mesh=None
            ) -> torch.Tensor:
    h = forward(params, tokens[:, :-1], cfg, mesh)
    return chunked_ce_loss(h, params["embed"], tokens[:, 1:], cfg, mesh)


def make_train_step(cfg: LMConfig, opt_cfg=None, mesh=None,
                    donate: bool = False):
    """``train_step(params, opt_state, tokens) -> (params, opt_state,
    metrics)``: the loss's gradient by autograd, then
    :func:`repro_torch.optim.adamw.apply`.  ``donate`` updates the given
    parameters and moments in place (the caller must not reuse them), as
    a jitted step that donates its buffers would.  With a ``mesh`` the
    arguments are DTensors placed by ``param_specs``, ``opt_specs`` and
    the tokens' batch spec (``adamw.make_step``)."""
    from repro_torch.optim import adamw

    opt_cfg = opt_cfg or adamw.AdamWConfig()
    return adamw.make_step(lambda p, tokens: loss_fn(p, tokens, cfg, mesh),
                           opt_cfg, donate=donate, mesh=mesh)


def cache_shapes(cfg: LMConfig, batch: int, seq: int) -> dict:
    """Abstract KV cache (``meta``): global layers cache ``seq``; local
    layers cache min(window, seq) (ring buffer); tail-local layers get
    their own rings."""
    nb, pe, kv, dh = cfg.n_blocks, cfg.period, cfg.n_kv, cfg.head_dim
    w = min(cfg.window, seq) if cfg.window else seq
    sd = lambda shape: _meta(shape, cfg.dtype)
    cache = {
        "k_g": sd((nb, batch, seq, kv, dh)),
        "v_g": sd((nb, batch, seq, kv, dh)),
    }
    if pe > 1:
        cache.update({
            "k_l": sd((nb, pe - 1, batch, w, kv, dh)),
            "v_l": sd((nb, pe - 1, batch, w, kv, dh)),
        })
    if cfg.tail_local:
        cache.update({
            "k_t": sd((cfg.tail_local, batch, w, kv, dh)),
            "v_t": sd((cfg.tail_local, batch, w, kv, dh)),
        })
    return cache


def cache_specs(cfg: LMConfig, mesh, *, seq_shard: bool = True) -> dict:
    """Global caches shard the sequence dim over ``model`` (split-KV
    decode); local ring buffers shard batch only (their window is
    small)."""
    from repro_torch.distributed.sharding import P, batch_axes

    ba = batch_axes(mesh)
    g = P(None, ba, "model", None, None) if seq_shard \
        else P(None, ba, None, None, None)
    out = {"k_g": g, "v_g": g}
    if cfg.period > 1:
        loc = P(None, None, ba, None, None, None)
        out.update({"k_l": loc, "v_l": loc})
    if cfg.tail_local:
        t = P(None, ba, None, None, None)
        out.update({"k_t": t, "v_t": t})
    return out


def init_cache(cfg: LMConfig, batch: int, seq: int, device=None) -> dict:
    """Zero caches of ``cache_shapes`` on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in cache_shapes(cfg, batch, seq).items()}


def _logits(x: torch.Tensor, params: dict, cfg: LMConfig) -> torch.Tensor:
    """Tied-embedding logits in the model's dtype, returned in float32."""
    return (x @ params["embed"].to(cfg.dtype).T).float()


@torch.no_grad()
def decode_step(params: dict, cache: dict, token: torch.Tensor, pos,
                cfg: LMConfig, mesh=None) -> tuple[torch.Tensor, dict]:
    """One decode step: returns (float32 logits (B, V), the cache).  The
    caches are updated in place: the token's K and V land at ``pos`` of a
    global cache and at ``pos % w`` of a ring."""
    if torch.is_tensor(pos) and pos.device.type == "meta":
        # a meta position has no value: the dry run decodes the last
        # one (the costs do not depend on it)
        pos = cache["k_g"].shape[2] - 1
    pos = int(pos)
    dev = token.device
    res = _res_spec(token[:, None], cfg, mesh)
    x = _hold(_embed(params, token[:, None], cfg, mesh), res, mesh)
    if cfg.period > 1:
        w = cache["k_l"].shape[3]
    elif cfg.tail_local:
        w = cache["k_t"].shape[2]
    else:
        w = 0
    qpos = torch.tensor([pos], device=dev)

    def layer(x, lp, kc, vc, *, is_global):
        """One decode layer against its cache (full context or ring)."""
        h = rms_norm(x, lp["rms1"])
        q = rope(_proj_any(h, lp["wq"], mesh), qpos, cfg.rope_theta)
        k = rope(_proj_any(h, lp["wk"], mesh), qpos, cfg.rope_theta)
        v = _proj_any(h, lp["wv"], mesh)
        if is_global or cfg.window == 0:
            kc = _cache_write(kc, k[:, 0], pos, mesh)
            vc = _cache_write(vc, v[:, 0], pos, mesh)
            kpos = torch.arange(kc.shape[1], device=dev)
            o = _attend_any(q, kc, vc, qpos, kpos, kpos <= pos, 0, lp, mesh)
        else:
            slot = pos % w
            kc = _cache_write(kc, k[:, 0], slot, mesh)
            vc = _cache_write(vc, v[:, 0], slot, mesh)
            ring = torch.arange(w, device=dev)
            # absolute position stored in each ring slot (floor modulo)
            kpos = pos - torch.remainder(slot - ring, w)
            o = _attend_any(q, kc, vc, qpos, kpos, kpos >= 0, cfg.window, lp,
                            mesh)
        x = _hold(x + _out_any(o, lp["wo"], mesh), res, mesh)
        h = rms_norm(x, lp["rms2"])
        return _hold(x + _ffn(h, lp, cfg, mesh), res, mesh)

    for bi in range(cfg.n_blocks):
        bp = _layer(params["layers"], bi)
        for li in range(cfg.period):
            lp = _layer(bp, li)
            if li == cfg.period - 1 or cfg.window == 0:
                x = layer(x, lp, cache["k_g"][bi], cache["v_g"][bi],
                          is_global=True)
            else:
                x = layer(x, lp, cache["k_l"][bi, li], cache["v_l"][bi, li],
                          is_global=False)
    for li in range(cfg.tail_local):  # trailing local-only layers
        x = layer(x, _layer(params["tail"], li), cache["k_t"][li],
                  cache["v_t"][li], is_global=False)
    x = rms_norm(x, params["final_norm"])
    return _logits(x, params, cfg)[:, 0], cache


@torch.no_grad()
def prefill_step(params: dict, tokens: torch.Tensor, cfg: LMConfig,
                 mesh=None) -> tuple[torch.Tensor, dict]:
    """Prefill: the full forward that also materializes the KV caches.

    Returns (last-token float32 logits (B, V), cache); a local layer's ring
    holds the last w positions rolled so position p sits at slot p % w."""
    b, s = tokens.shape
    res = _res_spec(tokens, cfg, mesh)
    x = _hold(_embed(params, tokens, cfg, mesh), res, mesh)
    w = min(cfg.window, s) if cfg.window else s
    from repro_torch.distributed.sharding import blockwise

    # DTensor of the card's torch has no rule for roll: a region, along
    # the sequence, which no placement here splits
    ring = lambda t: blockwise(lambda u: torch.roll(u, s % w, dims=1),
                               t[:, -w:])
    kg, vg, kl, vl = [], [], [], []
    for bi in range(cfg.n_blocks):
        bp = _layer(params["layers"], bi)
        kls, vls = [], []
        for li in range(cfg.period):
            lp = _layer(bp, li)
            is_global = li == cfg.period - 1
            window = 0 if (is_global or cfg.window == 0) else cfg.window
            h = rms_norm(x, lp["rms1"])
            attn, k, v = attention_full(h, lp, 0, window, cfg,
                                        return_kv=True, mesh=mesh)
            x = _hold(x + attn, res, mesh)
            if is_global or cfg.window == 0:
                kg_b, vg_b = k, v
            else:
                kls.append(ring(k))
                vls.append(ring(v))
            h2 = rms_norm(x, lp["rms2"])
            x = _hold(x + _ffn(h2, lp, cfg, mesh), res, mesh)
        kg.append(kg_b)
        vg.append(vg_b)
        if cfg.period > 1:
            kl.append(torch.stack(kls))
            vl.append(torch.stack(vls))
    cache = {"k_g": torch.stack(kg), "v_g": torch.stack(vg)}
    if cfg.period > 1:
        cache.update({"k_l": torch.stack(kl), "v_l": torch.stack(vl)})
    if cfg.tail_local:  # trailing local-only layers
        kts, vts = [], []
        for li in range(cfg.tail_local):
            lp = _layer(params["tail"], li)
            h = rms_norm(x, lp["rms1"])
            attn, k, v = attention_full(h, lp, 0, cfg.window, cfg,
                                        return_kv=True, mesh=mesh)
            x = _hold(x + attn, res, mesh)
            kts.append(ring(k))
            vts.append(ring(v))
            h2 = rms_norm(x, lp["rms2"])
            x = _hold(x + _ffn(h2, lp, cfg, mesh), res, mesh)
        cache.update({"k_t": torch.stack(kts), "v_t": torch.stack(vts)})
    x = rms_norm(x, params["final_norm"])
    return _logits(x[:, -1], params, cfg), cache
