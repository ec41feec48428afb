"""Fused k-means assign-and-accumulate (K2), port of
``repro.kernels.kmeans_assign.kmeans_assign_update``.

One Lloyd E+M data pass: for points x (N, D) and centroids (K, D) return
``(assign (N,) int32, min_dist (N,) f32, sums (K, D) f32, counts (K,)
int32)`` where assign is the argmin over K (first index on ties) of the
clamped squared distance, and sums/counts fold the points per centroid.
A non-finite coordinate follows the reference's one-hot fold
(:func:`one_hot_nan`).

* :func:`kmeans_assign_update_cuda` launches ``csrc/kmeans_assign.cu``:
  a tiled fp32 distance product fused with the argmin (128 x 128 block
  tiles, the block's rows resident in shared memory, tiles of the
  transposed centroids through a cp.async ring), then a deterministic
  M-step (per-cluster CSR in index order, one ordered segment sum per
  cluster; integer atomics only), so a build hashes the same run to run.
* :func:`kmeans_assign_update_plain` is the plain torch version, chunked
  over N like the reference's ``ops.kmeans_assign_update`` so the (chunk,
  K) distance tile stays bounded.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .ref import pairwise_l2_ref

SEGMENT = 2048              # points per segment of the CSR build
TILE_K = 128                # centroids per tile of the assign kernel (BN)
TILE_D = 32                 # columns per ring stage of the assign kernel (BK)


def kmeans_assign_update_plain(x: torch.Tensor, centroids: torch.Tensor,
                               *, chunk: int = 16384):
    """Plain torch version of the fused Lloyd pass (same contract)."""
    n, d = x.shape
    k = centroids.shape[0]
    xf = x.to(torch.float32)
    assign, mind = [], []
    for s in range(0, n, chunk):
        dist = pairwise_l2_ref(xf[s:s + chunk], centroids)
        a = torch.argmin(dist, dim=1)
        assign.append(a)
        mind.append(torch.gather(dist, 1, a[:, None])[:, 0])
    a = torch.cat(assign) if assign else x.new_zeros((0,), dtype=torch.long)
    md = torch.cat(mind) if mind else x.new_zeros((0,))
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    sums.index_add_(0, a, xf)
    counts = torch.bincount(a, minlength=k).to(torch.int32)
    return a.to(torch.int32), md, one_hot_nan(sums, a, xf), counts


def one_hot_nan(sums: torch.Tensor, a: torch.Tensor, x: torch.Tensor
                ) -> torch.Tensor:
    """The reference's one-hot rule for the sums (K, D) of points x (N, D)
    assigned ``a``: it folds them as onehot(a)^T @ x, where 0 x NaN and
    0 x inf are NaN, so sums[k, d] is NaN when column d holds a non-finite
    coordinate of a point outside cluster k; every other sum is left as
    it is.  Finite data (every build's) is returned unchanged."""
    bad = ~torch.isfinite(x)
    if not bool(bad.any()):
        return sums
    in_col = bad.sum(dim=0)                                       # (D,)
    own = torch.zeros(sums.shape, dtype=torch.int64, device=x.device)
    own.index_add_(0, a.long(), bad.long())                       # (K, D)
    return torch.where(own < in_col[None, :], float("nan"), sums)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"kmeans_assign_update kernel: {msg}")


def kmeans_assign_update_cuda(x: torch.Tensor, centroids: torch.Tensor):
    """Launch K2 on the tensors' CUDA device (current stream).

    Takes x (N, D) and centroids (K, D), f32, contiguous, on one CUDA
    device, with N >= 1, K >= 1 and any D.  Scratch (row norms, the
    centroids transposed and zero-padded to whole tiles, per-segment
    histogram of ceil(N / 2048) x K int32, CSR offsets and members, each
    column's count of non-finite coordinates) is allocated here.  Anything
    else raises; nothing falls back."""
    dev = x.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(centroids.device == dev, "x and centroids on different devices")
    _require(x.dtype == torch.float32 and centroids.dtype == torch.float32,
             "x and centroids must be f32")
    _require(x.is_contiguous() and centroids.is_contiguous(),
             "inputs must be contiguous")
    _require(x.dim() == 2 and centroids.dim() == 2
             and x.shape[1] == centroids.shape[1], "shapes (N, D), (K, D)")
    n, d = x.shape
    k = centroids.shape[0]
    _require(n >= 1 and k >= 1 and d >= 1, f"empty input N={n} K={k} D={d}")
    n_seg = -(-n // SEGMENT)
    _require(n_seg * k < 2 ** 31 and n * d < 2 ** 31
             and (d + TILE_D) * (k + TILE_K) < 2 ** 31,
             "index space exceeds int32")
    lib = cuda_lib.library()
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    mind = torch.empty((n,), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.int32, device=dev)
    kp = -(-k // TILE_K) * TILE_K
    x2 = torch.empty((n,), dtype=torch.float32, device=dev)
    c2 = torch.empty((kp,), dtype=torch.float32, device=dev)
    ct = torch.empty((-(-d // TILE_D) * TILE_D, kp), dtype=torch.float32,
                     device=dev)
    hist = torch.empty((n_seg, k), dtype=torch.int32, device=dev)
    offsets = torch.empty((k + 1,), dtype=torch.int32, device=dev)
    members = torch.empty((n,), dtype=torch.int32, device=dev)
    col_bad = torch.empty((d,), dtype=torch.int32, device=dev)
    rc = lib.kmeans_assign_update_launch(
        x.data_ptr(), centroids.data_ptr(), assign.data_ptr(),
        mind.data_ptr(), sums.data_ptr(), counts.data_ptr(), x2.data_ptr(),
        c2.data_ptr(), ct.data_ptr(), hist.data_ptr(), offsets.data_ptr(),
        members.data_ptr(), col_bad.data_ptr(), n, k, d, SEGMENT,
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "kmeans_assign_update")
    cuda_lib.LAUNCHES.add("kmeans_assign_update")
    return assign, mind, sums, counts
