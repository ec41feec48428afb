"""gemma3-27b [dense] 62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
5:1 local:global, 128k. [hf:google/gemma-3-1b-pt; unverified]

62 layers = 10 blocks of (5 local + 1 global) + 2 trailing local layers
(matches the HF gemma3 pattern: layer global iff (idx+1) % 6 == 0, pattern
truncated at the end) -> period=6, tail_local=2.  FSDP on d_ff so bf16
params + f32 moments fit 16 GB/chip.
"""
import torch
from repro_torch.configs import ArchDef, lm_shapes
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32, n_kv=16,
    d_ff=21504, vocab=262144, d_head=128, rope_theta=1_000_000.0,
    window=1024, period=6, tail_local=2, dtype=torch.bfloat16, fsdp=True,
)
_shapes, _skips = lm_shapes(sub_quadratic=True)
ARCH = ArchDef("gemma3_27b", "lm", CONFIG, _shapes,
               source="[hf:google/gemma-3-1b-pt; unverified]",
               skip_shapes=_skips)
