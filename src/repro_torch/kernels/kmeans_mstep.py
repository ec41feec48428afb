"""Fused Lloyd M-step (K3), port of
``repro.kernels.kmeans_mstep.kmeans_mstep``:

    new[k] = sums[k] / max(counts[k], 1)    counts[k] > 0
           = reseed[rank(k)]                counts[k] <= 0

where rank(k) counts the empty clusters before k, and ``reseed`` holds the
worst-served points in descending min-distance order (lowest point index
first among ties).

* :func:`kmeans_mstep_cuda` launches ``csrc/kmeans_mstep.cu`` (a block
  scan of the empty flags, then one elementwise pass).
* :func:`kmeans_mstep_plain` is the plain torch version.
"""
from __future__ import annotations

import torch

from . import cuda_lib


def kmeans_mstep_plain(sums: torch.Tensor, counts: torch.Tensor,
                       reseed: torch.Tensor) -> torch.Tensor:
    """Plain torch version: new centroids (K, D) f32."""
    cnt = counts.to(torch.float32)
    empty = cnt <= 0.0
    e = empty.to(torch.int64)
    rank = torch.cumsum(e, dim=0) - e
    mean = sums.to(torch.float32) / torch.clamp_min(cnt, 1.0)[:, None]
    return torch.where(empty[:, None], reseed.to(torch.float32)[rank], mean)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"kmeans_mstep kernel: {msg}")


def kmeans_mstep_cuda(sums: torch.Tensor, counts: torch.Tensor,
                      reseed: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the tensors' CUDA device (current stream).

    Takes sums (K, D) f32, counts (K,) of any real or integer dtype (made
    f32 here, as the reference does) and reseed (K', D) f32 with K' >= the
    number of empty clusters, contiguous on one CUDA device.  Anything else
    raises; nothing falls back."""
    dev = sums.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(counts.device == dev and reseed.device == dev,
             "inputs on different devices")
    _require(sums.dtype == torch.float32 and reseed.dtype == torch.float32,
             "sums and reseed must be f32")
    _require(sums.dim() == 2 and reseed.dim() == 2
             and reseed.shape[1] == sums.shape[1], "shapes (K, D), (K', D)")
    k, d = sums.shape
    _require(counts.shape == (k,), "counts shape (K,)")
    _require(k >= 1 and k * d < 2 ** 31, f"K={k}, D={d}")
    cnt = counts.to(torch.float32).contiguous()
    sums = sums.contiguous()
    reseed = reseed.contiguous()
    lib = cuda_lib.library()
    out = torch.empty((k, d), dtype=torch.float32, device=dev)
    rank = torch.empty((k + 1,), dtype=torch.int32, device=dev)
    rc = lib.kmeans_mstep_launch(sums.data_ptr(), cnt.data_ptr(),
                                 reseed.data_ptr(), out.data_ptr(),
                                 rank.data_ptr(), k, d,
                                 cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "kmeans_mstep")
    cuda_lib.LAUNCHES.add("kmeans_mstep")
    return out
