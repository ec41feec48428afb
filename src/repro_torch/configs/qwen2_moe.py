"""qwen2-moe-a2.7b [moe] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 + 4 shared. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Experts padded 60 -> 64 for even EP over model=16 (router masks the pads)."""
import torch
from repro_torch.configs import ArchDef, lm_shapes
from repro_torch.models.lm import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16, n_kv=16,
    d_ff=0, vocab=151936, d_head=128, dtype=torch.bfloat16,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared=4, d_ff_shared=1408, e_pad=64),
)
_shapes, _skips = lm_shapes(sub_quadratic=False)
ARCH = ArchDef("qwen2_moe", "lm", CONFIG, _shapes,
               source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]", skip_shapes=_skips)
