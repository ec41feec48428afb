"""Public kernel entry points (port of ``repro.kernels.ops``).

Each call dispatches on the device of the tensors it is given: tensors on
the CPU go to the kernel's plain torch version, CUDA tensors go to the
hand-written CUDA kernel, which launches or raises.  There is no fallback
from a CUDA tensor to a plain version.  Launches are counted in
``kernels/cuda_lib.LAUNCHES``; the plain versions launch nothing.
"""
from __future__ import annotations

import torch

from . import ivf_scan_q8 as _q8
from . import kmeans_assign as _assign
from . import kmeans_mstep as _mstep


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def kmeans_assign_update(x: torch.Tensor, centroids: torch.Tensor):
    """Fused Lloyd E+M pass: (assign (N,) i32, min_dist (N,) f32,
    sums (K, D) f32, counts (K,) i32)."""
    if _on_cpu(x):
        return _assign.kmeans_assign_update_plain(x, centroids)
    return _assign.kmeans_assign_update_cuda(x, centroids)


def kmeans_mstep(sums: torch.Tensor, counts: torch.Tensor,
                 reseed: torch.Tensor) -> torch.Tensor:
    """Fused M-step finisher: new centroids with empty clusters reseeded."""
    if _on_cpu(sums):
        return _mstep.kmeans_mstep_plain(sums, counts, reseed)
    return _mstep.kmeans_mstep_cuda(sums, counts, reseed)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """The unfused E-step of the reference runs on the ``pairwise_l2``
    kernel (src/repro/kernels/pairwise_l2.py), which a later slice ports."""
    raise NotImplementedError(
        "unfused k-means assign needs the pairwise_l2 kernel "
        "(src/repro/kernels/pairwise_l2.py), not ported yet; use the fused "
        "path (BuildConfig(fused_assign=True))")


def ivf_scan_q8_topk(q8, scale, norm2, centroids, posting_ids, cids, mask,
                     queries, *, k2: int):
    """Candidate-compressed int8-residual scan: ((B, k2) dists ascending,
    (B, k2) ids), unique by id, padded (+inf, -1)."""
    if _on_cpu(queries):
        return _q8.ivf_scan_q8_topk_plain(q8, scale, norm2, centroids,
                                          posting_ids, cids, mask, queries,
                                          k2=k2)
    return _q8.ivf_scan_q8_topk_cuda(q8, scale, norm2, centroids,
                                     posting_ids, cids, mask, queries, k2=k2)
