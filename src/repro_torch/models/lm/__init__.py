"""The decoder LM family (port of ``repro.models.lm``)."""
from .transformer import (
    LMConfig,
    cache_shapes,
    cache_specs,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    make_train_step,
    param_shapes,
    param_specs,
    prefill_step,
)
from .moe import MoEConfig
