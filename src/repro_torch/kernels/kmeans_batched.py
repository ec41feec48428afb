"""Batched Lloyd k-means (K23): every iteration of many independent
k-means sub-problems in one launch.  At the hierarchical splitter's shapes
it stands in for ``repro.kernels.kmeans_assign.kmeans_assign_update`` and
``repro.kernels.kmeans_mstep.kmeans_mstep``, and for the loop around them
(``repro.build.kmeans.kmeans(fused=True)``).

Sub-problem ``s`` is the rows ``x[pts[offs[s]:offs[s + 1]]]`` in that order,
clustered into ``k[s]`` (1..16) centroids started at its local rows
``init[s, :k[s]]``, for ``max(1, iters)`` Lloyd iterations, each of them:
the fused assign-and-accumulate pass, the ``k`` worst-served points by a
stable descending sort of the min distances, and the M-step that reseeds
empty clusters from them.  Returns ``(assign (T,) int32, min_dist (T,) f32,
cents (S, 16, D) f32, counts (S, 16) int32)``: the last E-step's local
clusters and min distances, the centroids after the last M-step and the
last E-step's counts; rows and counts past ``k[s]`` are 0.

* :func:`kmeans_batched_cuda` launches ``csrc/kmeans_batched.cu``: one
  block per sub-problem, all iterations inside the block, the arithmetic of
  K2 and K3 bit for bit.
* :func:`kmeans_batched_plain` is a loop over the sub-problems running
  :func:`lloyd`, the per-node loop, on the plain versions of K2 and K3; so
  on the CPU it is ``build.kmeans.kmeans`` exactly.

``x`` lies on the device; ``pts``, ``offs``, ``k`` and ``init`` are host
(CPU) int32 tensors, so that the CUDA wrapper can check every index before
it launches, and copies them to the card in one transfer.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .kmeans_assign import kmeans_assign_update_plain
from .kmeans_mstep import kmeans_mstep_plain

MAX_K = 16                  # centroids of one sub-problem
MAX_D = 1024


def lloyd(x: torch.Tensor, cents: torch.Tensor, iters: int, assign_update,
          mstep):
    """The fused per-node Lloyd loop: ``max(1, iters)`` rounds of
    ``assign_update`` (K2), the worst-served points by a stable descending
    sort (lowest index first among ties, NaN first, as the reference's
    ``jax.lax.top_k``) and ``mstep`` (K3).  Returns (centroids, assign,
    min_dist, counts) of the last round."""
    k = cents.shape[0]
    a = md = counts = None
    for _ in range(max(1, iters)):
        a, md, sums, counts = assign_update(x, cents)
        worst = torch.sort(md, descending=True, stable=True).indices[:k]
        cents = mstep(sums, counts, x[worst])
    return cents, a, md, counts


def kmeans_batched_plain(x: torch.Tensor, pts: torch.Tensor,
                         offs: torch.Tensor, k: torch.Tensor,
                         init: torch.Tensor, iters: int):
    """Plain torch version (same contract): the per-node loop on each
    sub-problem in turn."""
    s_n, d = k.shape[0], x.shape[1]
    xf = x.to(torch.float32)
    assign = torch.zeros((pts.shape[0],), dtype=torch.int32, device=x.device)
    mind = torch.zeros((pts.shape[0],), dtype=torch.float32, device=x.device)
    cents = torch.zeros((s_n, MAX_K, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((s_n, MAX_K), dtype=torch.int32, device=x.device)
    for s in range(s_n):
        lo, hi, ks = int(offs[s]), int(offs[s + 1]), int(k[s])
        xs = xf[pts[lo:hi].to(x.device).long()]
        c0 = xs[init[s, :ks].to(x.device).long()]
        c, a, md, cnt = lloyd(xs, c0, iters, kmeans_assign_update_plain,
                              kmeans_mstep_plain)
        assign[lo:hi] = a
        mind[lo:hi] = md
        cents[s, :ks] = c
        counts[s, :ks] = cnt
    return assign, mind, cents, counts


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"kmeans_batched kernel: {msg}")


def kmeans_batched_cuda(x: torch.Tensor, pts: torch.Tensor,
                        offs: torch.Tensor, k: torch.Tensor,
                        init: torch.Tensor, iters: int, *, events=None):
    """Launch K23 on x's CUDA device (current stream).

    Takes x (R, D) f32 contiguous on a CUDA device with 1 <= D <= 1024, and
    host int32 tensors pts (T,), offs (S+1,) rising from 0 to T, k (S,) and
    init (S, 16), with S >= 1, 1 <= k[s] <= min(16, n_s) for the n_s rows of
    sub-problem s, every pts in [0, R) and every init[s, :k[s]] in
    [0, n_s).  ``events``, a pair of CUDA events, is recorded on the
    current stream just before and after the launch, to time the kernel
    alone.  Anything else raises; nothing falls back."""
    dev = x.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(x.dtype == torch.float32 and x.is_contiguous() and x.dim() == 2,
             "x must be a contiguous (R, D) f32 tensor")
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    r_n, d = x.shape
    _require(1 <= d <= MAX_D, f"D={d} outside 1..{MAX_D}")
    for name, t in (("pts", pts), ("offs", offs), ("k", k), ("init", init)):
        _require(t.device.type == "cpu" and t.dtype == torch.int32,
                 f"{name} must be a host int32 tensor")
    s_n = k.shape[0]
    t_n = pts.shape[0]
    _require(s_n >= 1 and k.dim() == 1, "k must be (S,) with S >= 1")
    _require(pts.dim() == 1 and offs.shape == (s_n + 1,)
             and init.shape == (s_n, MAX_K), "shapes pts (T,), offs (S+1,), "
             "init (S, 16)")
    _require(int(iters) >= 1, f"iters={iters} must be >= 1")
    offs64 = offs.long()
    n = offs64[1:] - offs64[:-1]
    k64 = k.long()
    _require(int(offs64[0]) == 0 and int(offs64[-1]) == t_n,
             "offs must run from 0 to T")
    _require(bool((k64 >= 1).all()) and bool((k64 <= MAX_K).all())
             and bool((k64 <= n).all()), "needs 1 <= k[s] <= min(16, n_s)")
    if t_n:
        _require(int(pts.min()) >= 0 and int(pts.max()) < r_n,
                 "pts out of range")
    live = torch.arange(MAX_K)[None, :] < k64[:, None]
    init64 = init.long()
    _require(bool(((init64 >= 0) & (init64 < n[:, None]))[live].all()),
             "init out of range")
    _require(r_n * d < 2 ** 40 and t_n < 2 ** 31, "index space too large")
    meta = torch.cat([pts, offs, k, init.reshape(-1)]).to(dev)
    dp, do, dk, di = torch.split(meta, [t_n, s_n + 1, s_n, s_n * MAX_K])
    lib = cuda_lib.library()
    assign = torch.empty((t_n,), dtype=torch.int32, device=dev)
    mind = torch.empty((t_n,), dtype=torch.float32, device=dev)
    cents = torch.empty((s_n, MAX_K, d), dtype=torch.float32, device=dev)
    counts = torch.empty((s_n, MAX_K), dtype=torch.int32, device=dev)
    if events is not None:
        events[0].record()
    rc = lib.kmeans_batched_launch(
        x.data_ptr(), dp.data_ptr(), do.data_ptr(), dk.data_ptr(),
        di.data_ptr(), assign.data_ptr(), mind.data_ptr(), cents.data_ptr(),
        counts.data_ptr(), s_n, int(iters), d, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "kmeans_batched")
    cuda_lib.LAUNCHES.add("kmeans_batched")
    if events is not None:
        events[1].record()
    return assign, mind, cents, counts
