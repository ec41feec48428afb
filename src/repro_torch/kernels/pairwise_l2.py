"""Pairwise squared L2 distance tile (B5), port of
``repro.kernels.pairwise_l2.pairwise_l2``.

For a (N, D) and b (M, D) it returns the (N, M) f32 matrix
``max(||a||^2 - 2 a.b + ||b||^2, 0)``: the distance tile of the unfused
k-means E-step (``ops.kmeans_assign``).

* :func:`pairwise_l2_cuda` launches ``csrc/pairwise_l2.cu``: a
  register-tiled fp32 product with the row norms added in the epilogue.
* :func:`pairwise_l2_plain` is the plain torch version, the oracle's
  formula in the oracle's order, so on the CPU it gives the bits of the
  reference's ``pairwise_l2_ref``.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .ref import pairwise_l2_ref

MAX_GRID_Y = 65_535         # CUDA's limit on the grid's y extent


def pairwise_l2_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version: (N, M) squared L2, f32, clamped >= 0."""
    return pairwise_l2_ref(a, b)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pairwise_l2 kernel: {msg}")


def pairwise_l2_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch B5 on the tensors' CUDA device (current stream).

    Takes a (N, D) and b (M, D), f32, contiguous, on one CUDA device, with
    N, M, D >= 1 and M <= 64 * 65535.  The row norms are scratch allocated
    here.  Anything else raises; nothing falls back."""
    dev = a.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(b.device == dev, "a and b on different devices")
    _require(a.dtype == torch.float32 and b.dtype == torch.float32,
             "a and b must be f32")
    _require(a.is_contiguous() and b.is_contiguous(),
             "inputs must be contiguous")
    _require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[1],
             "shapes (N, D), (M, D)")
    n, d = a.shape
    m = b.shape[0]
    _require(n >= 1 and m >= 1 and d >= 1, f"empty input N={n} M={m} D={d}")
    _require(-(-m // 64) <= MAX_GRID_Y, f"M={m} exceeds the grid")
    lib = cuda_lib.library()
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    a2 = torch.empty((n,), dtype=torch.float32, device=dev)
    b2 = torch.empty((m,), dtype=torch.float32, device=dev)
    rc = lib.pairwise_l2_launch(a.data_ptr(), b.data_ptr(), a2.data_ptr(),
                                b2.data_ptr(), out.data_ptr(), n, m, d,
                                cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "pairwise_l2")
    cuda_lib.LAUNCHES.add("pairwise_l2")
    return out
