"""Core ANNS structures: distances, IVF index, quantization, LLSP."""
