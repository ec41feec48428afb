"""llama4-scout-17b-a16e [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + 1 shared expert. [hf:meta-llama/...; unverified]

~109B total params / ~17B active.  Expert weights FSDP-sharded over `data`
(ZeRO-3) on top of EP over `model`, so params+moments fit 16 GB HBM chips.
"""
import torch
from repro_torch.configs import ArchDef, lm_shapes
from repro_torch.models.lm import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv=8, d_ff=0, vocab=202048, d_head=128, dtype=torch.bfloat16, fsdp=True,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                  n_shared=1, d_ff_shared=8192),
)
_shapes, _skips = lm_shapes(sub_quadratic=False)
ARCH = ArchDef("llama4_scout", "lm", CONFIG, _shapes,
               source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
               skip_shapes=_skips)
