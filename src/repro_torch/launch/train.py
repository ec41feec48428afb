"""Training driver with checkpoint/restart and a fault-tolerant step loop
(port of ``repro.launch.train``).

Runs a registry arch at a ``--scale``-reduced config on the local device,
with the reference's flags and printed lines plus ``--device`` (default
``cuda``; ``cpu`` runs on the CPU, and without a card the default raises):

* checkpoint every ``--ckpt-every`` steps (params + opt state + data
  cursor), atomic publish, resume on restart (bit-exact);
* simulated worker failure: ``--fail-at N`` raises at step N; relaunching
  with the same ``--workdir`` resumes from the last checkpoint;
* gradient accumulation (``--accum``, the LM family): the microbatch
  gradients are averaged before one AdamW update.

LM archs train at ``scaled_lm_config(cfg, --scale)`` on ``token_batch``;
GraphCast at 4 layers of 64 on one constant ``random_graph(512, 2048,
32)``; recsys archs with ``table_rows = 1 << 14``.  ``--accum > 1`` raises
for the other families, as the reference's accumulation does.  The
reference's ``--accum`` path then fails on its own metrics (it prints a
``loss`` it never recorded); here the accumulated step reports the mean
microbatch loss as ``loss``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_moe \\
      --steps 50 --scale 0.02 --workdir /tmp/run1
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.configs import get
from repro_torch.data.synthetic import random_graph, recsys_batch, \
    token_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import tree_flatten, tree_map, \
    tree_unflatten
from repro_torch.optim import adamw


def scaled_lm_config(cfg, scale: float):
    """The reference's reduced LM config: every width scaled and rounded
    to a multiple, at least one block (and the tail), a window of at most
    64, ``q_chunk`` 64, float32, no FSDP."""
    def r(x, mult=1):
        return max(mult, int(round(x * scale)) // mult * mult)

    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            d_ff_expert=r(cfg.moe.d_ff_expert, 8),
            d_ff_shared=r(cfg.moe.d_ff_shared, 8) if cfg.moe.n_shared
            else 0,
            e_pad=cfg.moe.e_pad or 0,
        )
    period = cfg.period
    tail = cfg.tail_local
    n_layers = max(period + tail,
                   (cfg.n_layers * max(scale, 0.05)).__trunc__())
    n_layers = ((n_layers - tail) // period) * period + tail
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=r(cfg.d_model, 16),
        n_heads=max(2, r(cfg.n_heads, 2)),
        n_kv=max(1, min(cfg.n_kv, r(cfg.n_heads, 2) // 2)),
        d_head=r(cfg.d_head or cfg.d_model // cfg.n_heads, 8),
        d_ff=r(cfg.d_ff, 16) if cfg.d_ff else 0,
        vocab=r(cfg.vocab, 128),
        window=min(cfg.window, 64) if cfg.window else 0,
        q_chunk=64,
        dtype=torch.float32,
        fsdp=False,
        moe=moe,
    )


GNN_GRAPH = (512, 2048, 32)      # the GNN branch's constant batch


def make_batch_fn(arch, cfg, batch: int, seq: int, device):
    if arch.family == "lm":
        def fn(step: int):
            return torch.from_numpy(token_batch(batch, seq + 1, cfg.vocab,
                                                seed=step)).to(device)
        return fn
    if arch.family == "recsys":
        def fn(step: int):
            b = recsys_batch(batch, cfg.n_sparse, cfg.table_rows,
                             seq_len=cfg.seq_len, seed=step)
            return {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        return fn
    if arch.family == "gnn":
        n, e, f = GNN_GRAPH
        src, dst, feats = random_graph(n, e, f, seed=0)
        tgt = np.random.default_rng(1).normal(
            size=(n, cfg.n_vars)).astype(np.float32)
        const = {k: torch.from_numpy(v).to(device)
                 for k, v in (("node_feats", feats), ("src", src),
                              ("dst", dst), ("targets", tgt))}
        return lambda step: const
    raise ValueError(arch.family)


def make_accum_step(cfg, opt_cfg=None):
    """``step(params, opt_state, batches)`` over (A, B, S+1) microbatches:
    the mean of the microbatch gradients (summed in order, then divided
    by A), one AdamW update, and the mean microbatch loss as ``loss``."""
    from repro_torch.models.lm import transformer as tf

    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def step(params, opt_state, batches):
        leaves, structure = tree_flatten(params)
        g_acc = [torch.zeros_like(p) for p in leaves]
        losses = []
        for b in batches:
            live = [p.detach().requires_grad_(True) for p in leaves]
            with torch.enable_grad():
                loss = tf.loss_fn(tree_unflatten(structure, live), b, cfg)
                grads = torch.autograd.grad(loss, live)
            g_acc = [a + g for a, g in zip(g_acc, grads)]
            losses.append(loss.detach())
        n = len(losses)
        g = tree_map(lambda x: x / n, tree_unflatten(structure, g_acc))
        params, opt_state, metrics = adamw.apply(params, g, opt_state,
                                                 opt_cfg)
        metrics["loss"] = torch.stack(losses).mean()
        return params, opt_state, metrics

    return step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate a node failure at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain torch path)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    arch = get(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    if arch.family == "lm":
        from repro_torch.models.lm import transformer as tf
        cfg = scaled_lm_config(arch.config, args.scale)
        params = tf.init_params(cfg, gen, dev)
        step_fn = tf.make_train_step(cfg)
    elif arch.family == "recsys":
        from repro_torch.models.recsys import models as rm
        cfg = dataclasses.replace(arch.config, table_rows=1 << 14)
        params = rm.init_params(cfg, gen, dev)
        step_fn = rm.make_train_step(cfg)
    elif arch.family == "gnn":
        from repro_torch.models.gnn import graphcast as gc
        cfg = dataclasses.replace(arch.config, n_layers=4, d_hidden=64)
        params = gc.init_params(cfg, GNN_GRAPH[2], gen, dev)
        step_fn = gc.make_train_step(cfg)
    else:
        raise SystemExit(f"train.py does not drive family {arch.family!r}; "
                         "use launch/serve.py for the ANNS engine")
    if args.accum > 1:
        if arch.family != "lm":
            raise NotImplementedError(
                f"--accum {args.accum}: gradient accumulation drives the "
                f"LM family only, as the reference's does")
        step_fn = make_accum_step(cfg)

    n_params = sum(x.numel() for x in tree_flatten(params)[0])
    print(f"arch={arch.name} scaled params={n_params/1e6:.1f}M")
    opt_state = adamw.init(params)
    batch_fn = make_batch_fn(arch, cfg, args.batch, args.seq, dev)

    start = 0
    ckpt_root = os.path.join(args.workdir, "ckpt")
    if ckpt.latest_step(ckpt_root) is not None:
        (params, opt_state), start, extra = ckpt.restore((params, opt_state),
                                                         ckpt_root)
        print(f"resumed from step {start} (cursor={extra.get('cursor')})")

    t0 = time.perf_counter()
    for step in range(start, args.steps):
        if step == args.fail_at:
            raise RuntimeError(f"simulated node failure at step {step}")
        if args.accum > 1:
            batch = torch.stack([batch_fn(step * args.accum + i)
                                 for i in range(args.accum)])
        else:
            batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.perf_counter()-t0:.1f}s)", flush=True)
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            ckpt.save((params, opt_state), step + 1, ckpt_root,
                      extra={"cursor": step + 1})
    print("done")


if __name__ == "__main__":
    main()
