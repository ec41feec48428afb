"""Fused Lloyd M-step (K3), port of
``repro.kernels.kmeans_mstep.kmeans_mstep``:

    new[k] = sums[k] / max(counts[k], 1)    counts[k] > 0
           = reseed[rank(k)]                counts[k] <= 0

where rank(k) counts the empty clusters before k, and ``reseed`` holds the
worst-served points in descending min-distance order (lowest point index
first among ties).  Counts are taken as f32: an int32 count rounds to
nearest, as ``Tensor.to(torch.float32)`` rounds it.

* :func:`kmeans_mstep_cuda` launches ``csrc/kmeans_mstep.cu``: one launch,
  no scratch, int32 or f32 counts read as they are; each block ranks its
  rows from the flags before them.  The grid is
  :func:`kmeans_mstep_grid`'s, the word width :func:`kmeans_mstep_variant`'s.
* :func:`kmeans_mstep_plain` is the plain torch version.
"""
from __future__ import annotations

import torch

from . import cuda_lib

MIN_ROWS = 16              # rows a block at the least
MAX_BLOCKS = 264           # two blocks an SM of the H100's 132


def kmeans_mstep_plain(sums: torch.Tensor, counts: torch.Tensor,
                       reseed: torch.Tensor) -> torch.Tensor:
    """Plain torch version: new centroids (K, D) f32.  ``reseed`` (K', D)
    needs K' >= 1 and at least one row per empty cluster."""
    _require(reseed.shape[0] >= 1, "reseed needs at least one row")
    cnt = counts.to(torch.float32)
    empty = cnt <= 0.0
    e = empty.to(torch.int64)
    rank = torch.cumsum(e, dim=0) - e
    mean = sums.to(torch.float32) / torch.clamp_min(cnt, 1.0)[:, None]
    pick = torch.where(empty, rank, torch.zeros_like(rank))
    return torch.where(empty[:, None], reseed.to(torch.float32)[pick], mean)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"kmeans_mstep kernel: {msg}")


def kmeans_mstep_variant(d: int, *addresses: int) -> str:
    """The word width K3 moves rows in for width D and the byte addresses
    of sums, reseed and the output: "vec16" (16-byte words) when D % 4 == 0
    and every address is 16-byte aligned, so every row starts on a 16-byte
    boundary; else "vec4" (4-byte words)."""
    ok = d % 4 == 0 and all(a % 16 == 0 for a in addresses)
    return "vec16" if ok else "vec4"


def kmeans_mstep_grid(k: int, d: int) -> tuple[int, int]:
    """(blocks, rows a block) of K3 for K rows of width D.

    Block b reads the b * rows flags before its first row, so all blocks
    read about 2 K (blocks - 1) bytes of flags beside the output's 4 K D:
    at most D blocks keeps the flags under half the output's bytes.  At
    least ``MIN_ROWS`` rows a block, at most ``MAX_BLOCKS`` blocks."""
    blocks = max(1, min(-(-k // MIN_ROWS), d, MAX_BLOCKS))
    rows = -(-k // blocks)
    return -(-k // rows), rows


def _diagnose(sums, counts, reseed) -> None:
    """Raise the first reason :func:`kmeans_mstep_cuda` refuses its
    inputs."""
    dev = sums.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(counts.device == dev and reseed.device == dev,
             "inputs on different devices")
    _require(sums.dtype == torch.float32 and reseed.dtype == torch.float32,
             "sums and reseed must be f32")
    _require(counts.dtype in _COUNT_DTYPES,
             f"counts must be int32 or f32, got {counts.dtype}")
    _require(sums.dim() == 2 and reseed.dim() == 2
             and reseed.shape[1] == sums.shape[1], "shapes (K, D), (K', D)")
    k, d = sums.shape
    _require(counts.shape == (k,), "counts shape (K,)")
    _require(k >= 1 and d >= 1 and k * d < 2 ** 31, f"K={k}, D={d}")
    _require(reseed.shape[0] >= 1 and reseed.shape[0] * d < 2 ** 31,
             f"K'={reseed.shape[0]}")
    for name, t in (("sums", sums), ("counts", counts), ("reseed", reseed)):
        _require(t.is_contiguous(), f"{name} is not contiguous")


_COUNT_DTYPES = (torch.int32, torch.float32)


def kmeans_mstep_cuda(sums: torch.Tensor, counts: torch.Tensor,
                      reseed: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the tensors' CUDA device (current stream); one launch,
    and nothing allocated but the output.

    Takes sums (K, D) f32, counts (K,) int32 (K2's dtype) or f32 and
    reseed (K', D) f32 with K' >= 1 and at least one row per empty cluster
    (an empty cluster past the last row comes out NaN), contiguous on one
    CUDA device.  Anything else raises; nothing falls back.  The checks
    are one expression (a call's host time is most of its time at the
    splitter's K), and the message comes from :func:`_diagnose`."""
    dev = sums.device
    shape = sums.shape
    ok = (dev.type == "cuda" and len(shape) == 2
          and counts.device == dev and reseed.device == dev
          and sums.dtype == torch.float32 and reseed.dtype == torch.float32
          and counts.dtype in _COUNT_DTYPES and reseed.dim() == 2
          and counts.shape == shape[:1] and reseed.shape[1] == shape[1]
          and shape[0] >= 1 and shape[1] >= 1 and reseed.shape[0] >= 1
          and max(shape[0], reseed.shape[0]) * shape[1] < 2 ** 31
          and sums.is_contiguous() and counts.is_contiguous()
          and reseed.is_contiguous())
    if not ok:
        _diagnose(sums, counts, reseed)
    k, d = shape
    out = torch.empty((k, d), dtype=torch.float32, device=dev)
    ps, pr, po = sums.data_ptr(), reseed.data_ptr(), out.data_ptr()
    vec16 = kmeans_mstep_variant(d, ps, pr, po) == "vec16"
    _, rows = kmeans_mstep_grid(k, d)
    rc = cuda_lib.library().kmeans_mstep_launch(
        ps, counts.data_ptr(), pr, po, k, reseed.shape[0], d, rows,
        int(counts.dtype == torch.int32), int(vec16),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "kmeans_mstep")
    cuda_lib.LAUNCHES.add("kmeans_mstep")
    return out
