"""Training driver with checkpoint/restart and a fault-tolerant step loop
(port of ``repro.launch.train``, the recsys family).

Runs a registry arch on the local device, with the reference's flags and
printed lines plus ``--device`` (default ``cuda``; ``cpu`` runs on the
CPU, and without a card the default raises):

* checkpoint every ``--ckpt-every`` steps (params + opt state + data
  cursor), atomic publish, resume on restart (bit-exact);
* simulated worker failure: ``--fail-at N`` raises at step N; relaunching
  with the same ``--workdir`` resumes from the last checkpoint.

Recsys archs train with ``table_rows = 1 << 14``.  ``--accum > 1`` raises
for recsys, as the reference's accumulation (LM only) does; the LM and
GNN families are not ported yet (ROADMAP item 3).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mind --steps 20 \\
      --workdir /tmp/run1
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch import ckpt
from repro_torch.configs import get
from repro_torch.data.synthetic import recsys_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import tree_flatten
from repro_torch.optim import adamw

def make_batch_fn(arch, cfg, batch: int, seq: int, device):
    if arch.family == "recsys":
        def fn(step: int):
            b = recsys_batch(batch, cfg.n_sparse, cfg.table_rows,
                             seq_len=cfg.seq_len, seed=step)
            return {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        return fn
    raise ValueError(arch.family)


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
    try:
        arch = get(args.arch)
    except NotImplementedError as e:       # an LM or GNN arch
        raise SystemExit(str(e)) from None

    if arch.family == "recsys":
        from repro_torch.models.recsys import models as rm
        cfg = dataclasses.replace(arch.config, table_rows=1 << 14)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = rm.init_params(cfg, gen, dev)
        step_fn = rm.make_train_step(cfg)
    else:
        raise SystemExit(f"train.py does not drive family {arch.family!r}; "
                         "use launch/serve.py for the ANNS engine")
    if args.accum > 1:
        raise NotImplementedError(
            f"--accum {args.accum}: gradient accumulation drives the LM "
            f"family only, as the reference's does")

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
