"""gemma3-12b [dense] 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
5:1 local:global sliding window, 128k context. [hf:google/gemma-3-1b-pt; unverified]"""
import torch
from repro_torch.configs import ArchDef, lm_shapes
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16, n_kv=8,
    d_ff=15360, vocab=262144, d_head=256, rope_theta=1_000_000.0,
    window=1024, period=6, dtype=torch.bfloat16,
)
_shapes, _skips = lm_shapes(sub_quadratic=True)  # 5:1 sliding window
ARCH = ArchDef("gemma3_12b", "lm", CONFIG, _shapes,
               source="[hf:google/gemma-3-1b-pt; unverified]",
               skip_shapes=_skips)
