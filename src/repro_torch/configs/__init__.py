"""Architecture registry (port of ``repro.configs``): the 10 assigned
archs + the paper's own Helmsman config.

Each ``configs/<id>.py`` exports ``ARCH`` (an :class:`ArchDef`);
``get(name)`` and ``all_archs()`` are consumed by ``launch/train.py``,
``launch/dryrun.py`` and ``chip_smoke.py``.  Cell construction (abstract
inputs, step function and shardings per arch x shape x mesh) lives in
``launch/cells.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str                  # train | prefill | decode | serve | retrieval
    batch: int
    seq: int = 0               # LM context / recsys history
    extras: tuple = ()         # family-specific ((key, value), ...) pairs

    def get(self, key, default=None):
        for k, v in self.extras:
            if k == key:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                # lm | gnn | recsys | anns
    config: Any
    shapes: Dict[str, ShapeDef]
    source: str = ""           # [source; verified-tier] from the assignment
    skip_shapes: tuple = ()    # (shape_name, reason) pairs: recorded, not run


ARCH_NAMES = [
    "gemma3_12b", "phi4_mini", "gemma3_27b", "llama4_scout", "qwen2_moe",
    "graphcast",
    "xdeepfm", "wide_deep", "mind", "din",
    "helmsman",
]


def get(name: str) -> ArchDef:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.ARCH


def all_archs(include_extra: bool = True):
    """Every arch of the registry, as the reference lists them."""
    names = ARCH_NAMES if include_extra else ARCH_NAMES[:-1]
    return [get(n) for n in names]


# shared LM shape set (assignment: seq_len x global_batch)
def lm_shapes(*, sub_quadratic: bool):
    shapes = {
        "train_4k": ShapeDef("train_4k", "train", batch=256, seq=4096),
        "prefill_32k": ShapeDef("prefill_32k", "prefill", batch=32,
                                seq=32768),
        "decode_32k": ShapeDef("decode_32k", "decode", batch=128, seq=32768),
    }
    skips = ()
    if sub_quadratic:
        shapes["long_500k"] = ShapeDef("long_500k", "decode", batch=1,
                                       seq=524288)
    else:
        skips = (("long_500k",
                  "pure full-attention decoder: 500k-ctx decode requires "
                  "sub-quadratic attention (spec: skip & note in DESIGN.md)"),)
    return shapes, skips


RECSYS_SHAPES = {
    "train_batch": ShapeDef("train_batch", "train", batch=65536),
    "serve_p99": ShapeDef("serve_p99", "serve", batch=512),
    "serve_bulk": ShapeDef("serve_bulk", "serve", batch=262144),
    "retrieval_cand": ShapeDef(
        "retrieval_cand", "retrieval", batch=1,
        extras=(("n_candidates", 1_000_000),),
    ),
}
