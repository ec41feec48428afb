"""phi4-mini-3.8b [dense] 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
import torch
from repro_torch.configs import ArchDef, lm_shapes
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24, n_kv=8,
    d_ff=8192, vocab=200064, d_head=128, dtype=torch.bfloat16,
)
_shapes, _skips = lm_shapes(sub_quadratic=False)  # pure full attention
ARCH = ArchDef("phi4_mini", "lm", CONFIG, _shapes,
               source="[arXiv:2412.08905; hf]", skip_shapes=_skips)
