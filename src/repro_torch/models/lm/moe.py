"""Mixture-of-Experts FFN with expert parallelism (port of
``repro.models.lm.moe``).

Covers the two assigned MoE archs:
* llama4-scout: 16 routed experts, top-1, plus 1 shared expert.
* qwen2-moe:    60 routed experts (padded to 64 for even EP), top-4,
                plus 4 shared experts.

Per shard (the whole expert set when there is no mesh): mask the router
assignment to the local experts, select up to ``capacity`` tokens per
local expert by a stable sort of (expert, -prob), run the expert FFN as
one batched product, weight the outputs by the router probabilities and
combine each token's choices.  With a :class:`repro_torch.launch.mesh.Mesh`
whose ``model`` axis has TP > 1 ranks, each rank passes its own experts
(``moe_gate`` etc. hold E/TP of them, ``e0 = rank * E/TP``; with ``fsdp``
also its ``data`` block of d_ff, gathered first) and its batch block; the
partial outputs are summed over ``mesh.group("model")``, as the
reference's ``shard_map`` body does, with gradients
(``distributed/collectives.py`` ``psum``, ``copy_to``,
``all_gather_cat``).  Given DTensors (the global arrays) the same body
runs as a ``local_map``.

Ties: the router's top-k takes the lowest expert index first among equal
probabilities (``lax.top_k``), and the capacity race keeps the entry order
among equal keys (``jnp.argsort`` is stable): both are stable sorts here,
never ``torch.topk``.

The combine: the reference scatter-adds each token's K contributions
(``out.at[token_of].add``).  Here they are put back in the order that
scatter meets them (each token's entries by their sorted position) as a
(T, K, D) tensor and added one after another, so the sum has no atomics
and repeats bit for bit on the card and on the CPU.  The gathers with
repeated rows (a token's K entries) are ``F.embedding``, whose backward
is deterministic on both (advanced indexing's is not on the CPU).

``load_balance_loss`` is the reference's Switch-style auxiliary loss.  As
in the reference, nothing adds it to the training loss.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts (logical)
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0      # per shared expert
    e_pad: int = 0            # padded expert count for even EP (0 = n_experts)
    capacity_factor: float = 1.25
    aux_coef: float = 0.01

    @property
    def e(self) -> int:
        return self.e_pad or self.n_experts


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def moe_param_shapes(moe: MoEConfig, d: int, lead: tuple, dtype) -> dict:
    sd = lambda shape: _meta(lead + shape, dtype)
    e, fe = moe.e, moe.d_ff_expert
    out = {
        "moe_router": _meta(lead + (d, e), torch.float32),
        "moe_gate": sd((e, d, fe)),
        "moe_up": sd((e, d, fe)),
        "moe_down": sd((e, fe, d)),
    }
    if moe.n_shared:
        fs = moe.n_shared * moe.d_ff_shared
        out.update({
            "w_gate": sd((d, fs)),
            "w_up": sd((d, fs)),
            "w_down": sd((fs, d)),
        })
    return out


def moe_param_specs(moe: MoEConfig, fsdp: bool = False, n_lead: int = 2
                    ) -> dict:
    from repro_torch.distributed.sharding import P

    dp = "data" if fsdp else None
    lead = (None,) * n_lead
    out = {
        "moe_router": P(),
        "moe_gate": P(*lead, "model", None, dp),
        "moe_up": P(*lead, "model", None, dp),
        "moe_down": P(*lead, "model", dp, None),
    }
    if moe.n_shared:
        out.update({
            "w_gate": P(*lead, dp, "model"),
            "w_up": P(*lead, dp, "model"),
            "w_down": P(*lead, "model", dp),
        })
    return out


def _local_expert_ffn(
    x2d: torch.Tensor,        # (T, D) local tokens
    probs: torch.Tensor,      # (T, K) router probs of the top-k choices
    choice: torch.Tensor,     # (T, K) expert ids of the top-k choices
    gate: torch.Tensor,       # (Eloc, D, Fe)
    up: torch.Tensor,
    down: torch.Tensor,       # (Eloc, Fe, D)
    e0: int,                  # first expert id owned by this shard
    capacity: int,
) -> torch.Tensor:
    t, k = choice.shape
    e_loc = gate.shape[0]
    dev = x2d.device
    flat_choice = choice.reshape(-1)                    # (T*K,)
    flat_prob = probs.reshape(-1)
    local_eid = flat_choice - e0
    mine = (local_eid >= 0) & (local_eid < e_loc)
    eid = torch.where(mine, local_eid, e_loc)
    # rank slots per local expert: sort (expert, -prob) so each expert's
    # highest-prob tokens win the capacity race; the selection carries no
    # gradient (it reaches the router through the prob weights)
    sort_key = eid.to(torch.float32) * 2.0 - flat_prob.detach() * 1e-6
    order = torch.sort(sort_key, stable=True).indices
    sorted_eid = eid[order]
    # position within its expert group (the groups are contiguous)
    starts = torch.searchsorted(sorted_eid,
                                torch.arange(e_loc + 1, device=dev))
    slot_rank = torch.arange(t * k, device=dev) - starts[sorted_eid]
    keep = (sorted_eid < e_loc) & (slot_rank < capacity)
    slot = torch.where(keep, sorted_eid * capacity + slot_rank,
                       e_loc * capacity)
    # scatter token rows into (Eloc*capacity + 1 overflow, D)
    token_of = order // k
    rows = torch.where(keep[:, None], F.embedding(token_of, x2d), 0)
    buf = torch.zeros((e_loc * capacity + 1, x2d.shape[1]), dtype=x2d.dtype,
                      device=dev).index_put((slot,), rows)
    xe = buf[:-1].reshape(e_loc, capacity, -1)          # (Eloc, C, D)
    g = torch.bmm(xe, gate)
    u = torch.bmm(xe, up)
    y = torch.bmm(F.silu(g.float()).to(xe.dtype) * u, down)
    y = y.reshape(e_loc * capacity, -1)
    y = torch.cat([y, y.new_zeros((1, y.shape[1]))], dim=0)
    # gather back, weight by router prob
    w = torch.where(keep, flat_prob[order], 0.0)[:, None].to(y.dtype)
    contrib = F.embedding(slot, y) * w                  # (T*K, D) sorted
    # the combine: each token's K entries in their sorted order, added
    # one after another (the reference's scatter-add, without atomics)
    where = torch.empty_like(order)
    where[order] = torch.arange(t * k, device=dev)
    pos = torch.sort(where.view(t, k), dim=1).values
    per_token = contrib[pos]                            # (T, K, D)
    out = torch.zeros_like(x2d)
    for j in range(k):
        out = out + per_token[:, j]
    return out


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties lowest
    index first (``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router(x: torch.Tensor, lp: dict, moe: MoEConfig):
    """(float32 router logits (B, S, E), normalized top-k probs (B, S, K),
    expert ids (B, S, K))."""
    logits = x.float() @ lp["moe_router"].float()
    if moe.e != moe.n_experts:  # mask padded experts off
        pad_mask = torch.arange(moe.e, device=x.device) >= moe.n_experts
        logits = torch.where(pad_mask, -1e30, logits)
    probs_full = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs_full, moe.top_k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return logits, top_p, top_e


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _model_size(mesh) -> int:
    if mesh is not None and "model" in mesh.axis_names:
        return mesh.size("model")
    return 1


def _expert_parallel(moe: MoEConfig, mesh, fsdp: bool):
    """The expert-parallel body over this rank's experts (the reference's
    ``shard_map`` region): tokens and router picks as they are on the
    rank, ``copy_to`` over ``model`` on the tokens and probabilities
    (each model rank computes the part of their gradient that its experts
    give), the partial outputs ``psum``'d over ``model``; with ``fsdp``
    each expert weight's ``data`` block gathered first (a reduce-scatter
    in the backward).  Given DTensors it runs as a ``local_map`` with the
    reference's specs, the weights' gradients partial sums over the batch
    axes."""
    from repro_torch.distributed.collectives import all_gather_cat, \
        copy_to, psum
    from repro_torch.distributed.sharding import P, local_region, \
        partial_over

    tp = mesh.size("model")
    e_loc = moe.e // tp

    def body(x2d, probs2, choice2, gate, up, down):
        if gate.shape[0] != e_loc:
            raise ValueError(f"rank holds {gate.shape[0]} experts; mesh "
                             f"model={tp} needs {e_loc}")
        group = mesh.group("model")
        x2d, probs2 = copy_to(x2d, group), copy_to(probs2, group)
        if fsdp:  # ZeRO-3: gather the weight shard over `data` per use
            dgroup = mesh.group("data")
            gate = all_gather_cat(gate, dgroup, dim=2)
            up = all_gather_cat(up, dgroup, dim=2)
            down = all_gather_cat(down, dgroup, dim=1)
        e0 = mesh.index("model") * e_loc
        cap = max(1, int(math.ceil(x2d.shape[0] * moe.top_k / moe.e
                                   * moe.capacity_factor)))
        y = _local_expert_ffn(x2d, probs2, choice2, gate, up, down, e0, cap)
        return psum(y, group)

    ba = tuple(a for a in mesh.axis_names if a != "model")
    tok = P(ba)
    wdp = "data" if fsdp else None
    gu, dn = P("model", None, wdp), P("model", wdp, None)
    g = lambda spec: partial_over(spec, mesh, ba)
    return local_region(body, mesh, (tok, tok, tok, gu, gu, dn), (tok,),
                        (None, None, None, g(gu), g(gu), g(dn)))


def moe_ffn(
    x: torch.Tensor,          # (B, S, D): this rank's batch block
    lp: dict,                 # one layer's params incl. moe_* (this rank's
                              # experts when the mesh has TP > 1)
    moe: MoEConfig,
    mesh,
    fsdp: bool = False,
) -> torch.Tensor:
    b, s, d = x.shape
    _, top_p, top_e = router(x, lp, moe)
    tp = _model_size(mesh)
    x2d = x.reshape(b * s, d)
    probs2 = top_p.reshape(b * s, moe.top_k).float()
    choice2 = top_e.reshape(b * s, moe.top_k)
    gate, up, down = lp["moe_gate"], lp["moe_up"], lp["moe_down"]

    if tp == 1:
        if mesh is not None and mesh.world > 1:
            raise NotImplementedError(
                "moe_ffn on a mesh with one model rank: the reference's "
                "capacity race runs over the global batch; use a mesh "
                "whose model axis splits the experts")
        if mesh is not None and _is_dtensor(x2d):     # a one-rank mesh
            routed = _expert_parallel(moe, mesh, fsdp)(x2d, probs2, choice2,
                                                       gate, up, down)
        else:
            capacity = max(1, int(math.ceil(b * s * moe.top_k / moe.e
                                            * moe.capacity_factor)))
            routed = _local_expert_ffn(x2d, probs2, choice2, gate, up, down,
                                       0, capacity)
    else:
        routed = _expert_parallel(moe, mesh, fsdp)(x2d, probs2, choice2,
                                                   gate, up, down)
    out = routed.reshape(b, s, d)

    if moe.n_shared:
        g = x @ lp["w_gate"]
        u = x @ lp["w_up"]
        out = out + (F.silu(g.float()).to(x.dtype) * u) @ lp["w_down"]
    return out.to(x.dtype)


def load_balance_loss(logits: torch.Tensor, top_e: torch.Tensor,
                      moe: MoEConfig) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    probs = torch.softmax(logits, dim=-1)
    p_mean = probs.mean(dim=(0, 1))
    onehot = F.one_hot(top_e[..., 0].long(), moe.e).to(torch.float32)
    f = onehot.mean(dim=(0, 1))
    return moe.e * torch.sum(f * p_mean) * moe.aux_coef
