"""PyTorch + CUDA port of the Helmsman ANNS system (``repro`` is the JAX
reference).  Module names mirror ``repro``'s so each counterpart is easy to
find.  The port imports ``torch`` and never ``jax`` or ``repro``.

Entry points (``build.pipeline.build_index``,
``runtime.pipeline.make_quantized_pipeline``, ``PrefetchPipeline``) run on
CUDA unless the caller passes ``device="cpu"``; with no device given and no
card present they raise.
"""
