"""Pairwise squared L2 distance tile (B5), port of
``repro.kernels.pairwise_l2.pairwise_l2``.

For a (N, D) and b (M, D) it returns the (N, M) f32 matrix
``max(||a||^2 - 2 a.b + ||b||^2, 0)``: the distance tile of the unfused
k-means E-step (``ops.kmeans_assign``).

* :func:`pairwise_l2_cuda` launches ``csrc/pairwise_l2.cu`` in one of two
  variants that :func:`pairwise_l2_variant` picks by shape: "narrow" (M up
  to :data:`NARROW_MAX_M`, as the splitter's 2- to 8-means: one launch, all
  of b staged in each block, no scratch) or "wide" (K2's register-tiled
  fp32 product with the distances stored, behind a prep launch that
  transposes b into scratch).  Both give the bits of K2's E-step.
* :func:`pairwise_l2_plain` is the plain torch version, the oracle's
  formula in the oracle's order, so on the CPU it gives the bits of the
  reference's ``pairwise_l2_ref``.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .ref import pairwise_l2_ref

# The narrow variant stages b and up to NARROW_PAIRS // M rows of a in
# NARROW_SMEM bytes of shared memory (csrc/pairwise_l2.cu: kNarrowSmem,
# kNarrowPairs, narrow_rows); it serves M <= NARROW_MAX_M when that fits.
NARROW_MAX_M = 32
NARROW_SMEM = 48 * 1024
NARROW_PAIRS = 512
WIDE_BN, WIDE_BK = 128, 32  # the wide scratch's padding of M and D


def pairwise_l2_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version: (N, M) squared L2, f32, clamped >= 0."""
    return pairwise_l2_ref(a, b)


def narrow_rows(m: int, d: int) -> int:
    """Rows of a that one narrow block stages beside all of b (0: b does
    not fit in the block's shared memory)."""
    ld4 = -(-d // 4) | 1
    fit = NARROW_SMEM // (ld4 * 16 + 4) - m
    return 0 if fit < 1 else min(fit, -(-NARROW_PAIRS // m))


def pairwise_l2_variant(n: int, m: int, d: int) -> str:
    """The kernel variant B5 runs at (N, M, D): "narrow" or "wide"."""
    del n  # the choice depends on the centroids only
    return "narrow" if m <= NARROW_MAX_M and narrow_rows(m, d) >= 1 \
        else "wide"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pairwise_l2 kernel: {msg}")


def pairwise_l2_cuda(a: torch.Tensor, b: torch.Tensor, *,
                     variant: str | None = None) -> torch.Tensor:
    """Launch B5 on the tensors' CUDA device (current stream).

    Takes a (N, D) and b (M, D), f32, contiguous, on one CUDA device, with
    N, M, D >= 1.  ``variant`` ("narrow" or "wide") overrides
    :func:`pairwise_l2_variant`; "narrow" raises where b does not fit.
    Only the output is allocated for the narrow variant; the wide one also
    allocates its scratch, and when M % 4 != 0 returns the (N, M) view of
    an (N, M rounded up to 4) buffer, so that its kernel writes every row
    with 16-byte stores.  Anything else raises; nothing falls back."""
    dev = a.device
    if not (a.is_cuda and b.device == dev and a.dtype == torch.float32
            and b.dtype == torch.float32 and a.dim() == 2 and b.dim() == 2
            and a.shape[1] == b.shape[1] and a.is_contiguous()
            and b.is_contiguous()):
        # the slow path only names what is wrong: one condition above keeps
        # the unfused build's thousands of small calls cheap on the host
        _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
        _require(b.device == dev, "a and b on different devices")
        _require(a.dtype == torch.float32 and b.dtype == torch.float32,
                 "a and b must be f32")
        _require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[1],
                 "shapes (N, D), (M, D)")
        _require(False, "inputs must be contiguous")
    n, d = a.shape
    m = b.shape[0]
    _require(n >= 1 and m >= 1 and d >= 1, f"empty input N={n} M={m} D={d}")
    if variant is None:
        variant = pairwise_l2_variant(n, m, d)
    elif variant == "narrow":
        _require(narrow_rows(m, d) >= 1,
                 f"narrow variant: M={m} rows of D={d} do not fit")
    else:
        _require(variant == "wide", f"unknown variant {variant!r}")
    lib = cuda_lib.library()
    if variant == "narrow":
        out = a.new_empty((n, m))
        ldo, scratch = m, 0
    else:
        ldo = -(-m // 4) * 4
        out = a.new_empty((n, ldo))
        mp = -(-m // WIDE_BN) * WIDE_BN
        dp = -(-d // WIDE_BK) * WIDE_BK
        buf = a.new_empty((dp * mp + mp + n,))
        scratch = buf.data_ptr()
    rc = lib.pairwise_l2_launch(a.data_ptr(), b.data_ptr(), scratch,
                                out.data_ptr(), n, m, d, ldo,
                                0 if variant == "narrow" else 1,
                                cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "pairwise_l2")
    cuda_lib.LAUNCHES.add("pairwise_l2")
    return out if ldo == m else out[:, :m]
