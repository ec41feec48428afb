"""AdamW + schedules + gradient utilities (port of ``repro.optim.adamw``).

Plain functions over trees of tensors (nested dicts, lists and tuples,
flattened in the reference's order), not ``torch.optim``: the reference's
update order is kept (clip by the global norm, then the moments, the bias
corrections ``b ** t`` in float32, then ``p - lr * (mhat / (sqrt(vhat) +
eps) + wd * p)``), and ``torch.optim.AdamW`` and
``torch.nn.utils.clip_grad_norm_`` differ from it in the weight-decay
order, the epsilon and the clip rule.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple, Union

import torch

from repro_torch.distributed.collectives import tree_flatten, tree_map, \
    tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    mu: object            # tree like params
    nu: object


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params) -> AdamWState:
    leaves, _ = tree_flatten(params)
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the leaves' float32 squared sums, added in tree order."""
    total = 0
    for leaf in tree_flatten(tree)[0]:
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


# rows of a leaf updated at once in place (``apply(donate=True)``): the
# update is elementwise, so any split gives the same bits
DONATE_CHUNK = 1 << 24


def _update(p, g, m, v, scale, cfg: AdamWConfig, bc1, bc2, lr):
    """One leaf's (new param, m, v): the clipped gradient ``g * scale`` in
    g's dtype (as ``clip_by_global_norm`` gives it), then the moments and
    the step in float32."""
    g = (g * scale).to(torch.float32)
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mhat = m / bc1
    vhat = v / bc2
    new_p = p - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                      + cfg.weight_decay * p)
    return new_p.to(p.dtype), m, v


def _update_in_place(p, g, m, v, upd):
    """``upd`` over row blocks of one leaf, written into ``p`` and into the
    moments (new float32 moments when ``m`` and ``v`` are of another
    dtype, as at the first step of bf16 params); returns (m, v)."""
    m_out = m if m.dtype == torch.float32 else torch.empty(
        m.shape, dtype=torch.float32, device=m.device)
    v_out = v if v.dtype == torch.float32 else torch.empty(
        v.shape, dtype=torch.float32, device=v.device)
    if p.dim() == 0:
        blocks = [...]
    else:
        rows = max(1, DONATE_CHUNK // max(1, p[0].numel()))
        blocks = [slice(i, i + rows) for i in range(0, p.shape[0], rows)]
    for b in blocks:
        np_, nm, nv = upd(p[b], g[b], m[b], v[b])
        p[b] = np_
        m_out[b] = nm
        v_out[b] = nv
    return m_out, v_out


@torch.no_grad()
def apply(params, grads, state: AdamWState, cfg: AdamWConfig,
          lr_scale: Union[torch.Tensor, float] = 1.0, donate: bool = False):
    """One AdamW update. Returns (new_params, new_state, metrics).

    ``donate`` writes the new parameters and moments into the given
    tensors (moments of another dtype than float32 are replaced), a row
    block at a time: the same bits as the functional update, without a
    second copy of the state."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    step = state.step + 1
    t = step.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(f32(cfg.b1), t)
    bc2 = 1.0 - torch.pow(f32(cfg.b2), t)
    lr = cfg.lr * lr_scale
    upd = lambda p, g, m, v: _update(p, g, m, v, scale, cfg, bc1, bc2, lr)

    leaves, structure = tree_flatten(params)
    others = [tree_flatten(tr)[0] for tr in (grads, state.mu, state.nu)]
    if donate:
        moments = [_update_in_place(*xs, upd)
                   for xs in zip(leaves, *others)]
        out = [(p, m, v) for p, (m, v) in zip(leaves, moments)]
    else:
        out = [upd(*xs) for xs in zip(leaves, *others)]
    pick = lambda j: tree_unflatten(structure, [o[j] for o in out])
    return (pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)),
            {"grad_norm": gnorm,
             "lr": torch.as_tensor(lr, dtype=torch.float32,
                                   device=t.device)})


def make_step(loss_fn, cfg: AdamWConfig, donate: bool = False, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``loss_fn(params, batch)``'s gradient by autograd, then
    :func:`apply`; ``metrics["loss"]`` is the loss.

    Over DTensors (a mesh step) each gradient is first moved to its
    moments' placements (a reduce-scatter over ``data`` for a ZeRO-1
    moment, an all-reduce for a replicated one), the update runs on those
    blocks, and the new parameters and moments come back on the
    placements they came in on (the parameters' all-gather of ZeRO-1).
    ``donate`` (one process only) updates in place.  With a ``mesh`` the
    step refuses parameters that are not DTensors."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import implicit_replication

    def train_step(params, opt_state, batch):
        leaves, structure = tree_flatten(params)
        mesh_step = isinstance(leaves[0], DTensor)
        if mesh is not None and not mesh_step:
            raise TypeError("a mesh step takes the global arrays as "
                            "DTensors (distributed/sharding.py distribute)")
        if mesh_step and donate:
            raise ValueError("donate is for a one-process step")
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad(), (implicit_replication() if mesh_step
                                   else contextlib.nullcontext()):
            loss = loss_fn(tree_unflatten(structure, live), batch)
            grads = torch.autograd.grad(loss, live)
        del live
        if not mesh_step:
            params, opt_state, metrics = apply(
                params, tree_unflatten(structure, list(grads)), opt_state,
                cfg, donate=donate)
            metrics["loss"] = loss.detach()
            return params, opt_state, metrics
        with implicit_replication():
            moments = tree_flatten(opt_state.mu)[0]
            grads = [g.redistribute(m.device_mesh, m.placements)
                     for g, m in zip(grads, moments)]
            new_p, new_s, metrics = apply(
                params, tree_unflatten(structure, grads), opt_state, cfg)
            back = lambda new, old: new.redistribute(old.device_mesh,
                                                     old.placements)
            new_p = tree_map(back, new_p, params)
            new_s = AdamWState(step=new_s.step,
                               mu=tree_map(back, new_s.mu, opt_state.mu),
                               nu=tree_map(back, new_s.nu, opt_state.nu))
        metrics["loss"] = loss.detach()
        return new_p, new_s, metrics

    return train_step


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def f(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp_max(step / max(warmup, 1), 1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                  * prog))
        return warm * cos
    return f
