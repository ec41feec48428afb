"""Operations and bytes of one call of each measured kernel, from its inputs
and the plan, and the least time the card could take for them.

The counts depend only on what the call has to do, never on how a kernel
does it: each input byte is counted once (the probed clusters' payload,
the queries, the plan) and each output byte once, whatever a kernel reads
again; operations are counted for the probes these inputs ask for.  A
kernel's roofline share is ``bound / device time``; it cannot pass 100%
unless the counts are too high or the time leaves out part of the work.

Peaks are NVIDIA's published dense rates of one H100 SXM at its full 700 W
power limit: 67 TFLOP/s of float32 on the CUDA cores (the scan and k-means
kernels multiply in float32 outside the tensor cores) and 3.35 TB/s of
HBM3.  The harness prints the card's power limit beside every share.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


@dataclasses.dataclass
class Work:
    ops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    def bound_s(self, peak_flops: float = PEAK_FP32_FLOPS,
                peak_bytes: float = PEAK_HBM_BYTES) -> float:
        return max(self.ops / peak_flops, self.bytes / peak_bytes)

    def bound_by(self, peak_flops: float = PEAK_FP32_FLOPS,
                 peak_bytes: float = PEAK_HBM_BYTES) -> str:
        return ("operations" if self.ops / peak_flops
                >= self.bytes / peak_bytes else "bytes")


def k1_call(batch: int, probes: int, union: int, width: int, cluster_len: int,
            dim: int, k2: int) -> Work:
    """K1 ``ivf_scan_q8_topk``: ``batch`` queries with ``probes`` live
    (query, cluster) probes in all, over ``union`` distinct streamed
    clusters of int8 residual codes; ``width`` is the plan's probe columns.

    Bytes: each union cluster's codes (L x D int8), norms and ids (L x 4 B
    each), centroid (D x 4 B) and scale (4 B); the queries; the plan's ids
    (4 B) and mask (1 B) per column; the (batch, k2) distances and ids.
    Operations: per probe, ||q - c||^2 (3 D) and per row the dot with the
    codes (2 D) and the closed-form combine (4)."""
    per_cluster = cluster_len * dim + 8 * cluster_len + 4 * dim + 4
    nbytes = (union * per_cluster + batch * dim * 4 + batch * width * 5
              + batch * k2 * 8)
    ops = probes * (3 * dim + cluster_len * (2 * dim + 4))
    return Work(float(ops), float(nbytes))


def b2_call(batch: int, probes: int, union: int, width: int, cluster_len: int,
            dim: int, k2: int) -> Work:
    """B2 ``ivf_scan_topk`` over resident f32 postings: as :func:`k1_call`
    with a float32 payload (L x D x 4 B and L ids a cluster).  Operations:
    per probe and row the dot (2 D) and the combine (3); per union row its
    norm (2 D); per query its norm (2 D)."""
    per_cluster = cluster_len * dim * 4 + 4 * cluster_len
    nbytes = (union * per_cluster + batch * dim * 4 + batch * width * 5
              + batch * k2 * 8)
    ops = (probes * cluster_len * (2 * dim + 3)
           + union * cluster_len * 2 * dim + batch * 2 * dim)
    return Work(float(ops), float(nbytes))


def k23_call(sizes: Sequence[int], ks: Sequence[int], dim: int,
             iters: int) -> Work:
    """K23 ``kmeans_batched``: sub-problem s clusters ``sizes[s]`` points
    into ``ks[s]`` centroids for ``max(1, iters)`` Lloyd iterations.

    Bytes: the points once (T x D x 4), their row ids (T x 4), the start
    rows (S x 16 x 4), offsets and k (S x 8); out the assignments and min
    distances (T x 8), centroids (S x 16 x D x 4) and counts (S x 16 x 4).
    Operations per iteration: each point's distance to each of its
    sub-problem's centroids (2 D: the dot of the expanded form, the norms
    being a point's own) and its share of the centroid sums (D)."""
    it = max(1, int(iters))
    t = int(sum(sizes))
    s = len(sizes)
    nbytes = (t * dim * 4 + t * 4 + s * 16 * 4 + s * 8
              + t * 8 + s * 16 * dim * 4 + s * 16 * 4)
    ops = it * sum(int(n) * (2 * dim * int(k) + dim)
                   for n, k in zip(sizes, ks))
    return Work(float(ops), float(nbytes))


def share_pct(work: Work, device_s: float) -> float:
    """Roofline share in percent: the bound over the measured time."""
    if device_s <= 0.0:
        raise ValueError("no device time to compare with")
    return 100.0 * work.bound_s() / device_s
