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


@torch.no_grad()
def apply(params, grads, state: AdamWState, cfg: AdamWConfig,
          lr_scale: Union[torch.Tensor, float] = 1.0):
    """One AdamW update. Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    t = step.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(f32(cfg.b1), t)
    bc2 = 1.0 - torch.pow(f32(cfg.b2), t)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        new_p = p - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * p)
        return new_p.to(p.dtype), m, v

    leaves, structure = tree_flatten(params)
    others = [tree_flatten(tr)[0] for tr in (grads, state.mu, state.nu)]
    out = [upd(*xs) for xs in zip(leaves, *others)]
    pick = lambda j: tree_unflatten(structure, [o[j] for o in out])
    return (pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)),
            {"grad_norm": gnorm,
             "lr": torch.as_tensor(lr, dtype=torch.float32,
                                   device=t.device)})


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
