"""Hand-written CUDA kernels (csrc/) with their plain torch versions."""
