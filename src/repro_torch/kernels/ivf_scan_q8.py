"""Fused int8-residual posting scan with in-kernel dedup top-k2 (K1).

Port of ``repro.kernels.ivf_scan_q8.ivf_scan_q8_topk``.  The payload is the
int8 residual code of ``core/quantize.py``; the distance uses the
closed-form residual expansion

    ||q - (c + s r8)||^2 = ||q - c||^2 - 2 s (q - c).r8 + s^2 ||r8||^2

with the per-slot ``s^2 ||r8||^2`` precomputed (``norm2``).

* :func:`ivf_scan_q8_topk_cuda` launches the CUDA kernel
  (``csrc/ivf_scan_q8.cu``: one block per query walking its deduped probe
  plan, fp32 distances, warp-level unique-by-id top-k2 merge).
* :func:`ivf_scan_q8_topk_plain` is the plain torch version of the same
  function: the same plan, every planned (query, row) distance, then the
  ``extract_topk`` merge rule.

``kernels/ops.py`` chooses between them by the device of the tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.distance import INF

from . import cuda_lib
from .ivf_scan import extract_topk, plan_tile_probes

MAX_K2 = 256
MAX_D = 1024
MAX_L = 1024
MAX_SMEM = 232_448          # bytes of shared memory one block may use


def ivf_scan_q8_topk_plain(q8, scale, norm2, centroids, posting_ids, cids,
                           mask, queries, *, k2: int):
    """Plain torch version: ((B, k2) ascending dists, (B, k2) ids)."""
    r_count = q8.shape[0]
    b, p = cids.shape
    tile_cids, qsel = plan_tile_probes(cids, mask, 1, r_count)
    rows = tile_cids.long()                                   # (B, P)
    g8 = q8[rows].to(torch.float32)                           # (B, P, L, D)
    qc = queries.to(torch.float32)[:, None, :] - centroids[rows]
    cross = torch.einsum("bpd,bpld->bpl", qc, g8)
    d = (torch.sum(qc * qc, dim=-1)[:, :, None]
         - 2.0 * scale.reshape(-1)[rows][:, :, None] * cross + norm2[rows])
    d = torch.clamp_min(d, 0.0)
    ids = posting_ids[rows]                                   # (B, P, L)
    live = (qsel.reshape(b, p) != 0)[:, :, None] & (ids >= 0)
    d = torch.where(live, d, INF)
    return extract_topk(d.reshape(b, -1), ids.reshape(b, -1), k2)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ivf_scan_q8_topk kernel: {msg}")


def ivf_scan_q8_topk_cuda(q8, scale, norm2, centroids, posting_ids, cids,
                          mask, queries, *, k2: int):
    """Launch K1 on the tensors' CUDA device (current stream).

    Takes q8 (R, L, D) int8, scale (R, 1, 1) f32, norm2 (R, L) f32,
    centroids (R, D) f32, posting_ids (R, L) int32, cids (B, P) int,
    mask (B, P) bool, queries (B, D) f32, all contiguous on one CUDA device.
    Limits: 1 <= k2 <= 256, D % 4 == 0 and D <= 1024, L <= 1024, and the
    block's shared memory (the (L, D) code block plus small buffers) within
    227 KB.  Anything else raises; nothing falls back to the plain version.
    """
    dev = queries.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    tensors = dict(q8=q8, scale=scale, norm2=norm2, centroids=centroids,
                   posting_ids=posting_ids, cids=cids, mask=mask,
                   queries=queries)
    for name, t in tensors.items():
        _require(t.device == dev, f"{name} on {t.device}, queries on {dev}")
        _require(t.is_contiguous(), f"{name} is not contiguous")
    _require(q8.dtype == torch.int8, "q8 must be int8")
    for name in ("scale", "norm2", "centroids", "queries"):
        _require(tensors[name].dtype == torch.float32, f"{name} must be f32")
    _require(posting_ids.dtype == torch.int32, "posting_ids must be int32")
    r_count, l, d = q8.shape
    b, p = cids.shape
    _require(scale.shape == (r_count, 1, 1), f"scale {tuple(scale.shape)}")
    _require(norm2.shape == (r_count, l), f"norm2 {tuple(norm2.shape)}")
    _require(centroids.shape == (r_count, d), "centroids shape")
    _require(posting_ids.shape == (r_count, l), "posting_ids shape")
    _require(mask.shape == (b, p), "mask shape")
    _require(queries.shape == (b, d), "queries shape")
    _require(1 <= k2 <= MAX_K2, f"k2={k2} outside [1, {MAX_K2}]")
    _require(d % 4 == 0 and 0 < d <= MAX_D, f"D={d} (multiple of 4, <= {MAX_D})")
    _require(0 < l <= MAX_L, f"L={l} outside [1, {MAX_L}]")
    _require(r_count > 0, "no posting rows")
    lib = cuda_lib.library()
    smem = lib.ivf_scan_q8_topk_smem_bytes(l, d, k2)
    _require(smem <= MAX_SMEM, f"needs {smem} B of shared memory")
    out_d = torch.empty((b, k2), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k2), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    tile_cids, qsel = plan_tile_probes(cids, mask, 1, r_count)
    qsel = qsel.reshape(b, p).contiguous()
    tile_cids = tile_cids.contiguous()
    rc = lib.ivf_scan_q8_topk_launch(
        q8.data_ptr(), scale.data_ptr(), norm2.data_ptr(),
        centroids.data_ptr(), posting_ids.data_ptr(), tile_cids.data_ptr(),
        qsel.data_ptr(), queries.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), b, p, l, d, k2, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "ivf_scan_q8_topk")
    cuda_lib.LAUNCHES.add("ivf_scan_q8_topk")
    return out_d, out_i
