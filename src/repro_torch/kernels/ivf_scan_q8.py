"""int8-residual posting scans: the fused scan with in-kernel dedup top-k2
(K1) and the legacy full-distance scan (B7).

Port of ``repro.kernels.ivf_scan_q8`` (``ivf_scan_q8_topk`` and
``ivf_scan_q8``).  The payload is the
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
* :func:`ivf_scan_q8_cuda` launches B7 (``csrc/ivf_scan_q8_legacy.cu``: one
  block per (query, probe), (B, P, L) distances, masked probes +inf);
  :func:`ivf_scan_q8_plain` is the arithmetic of
  ``core.quantize.ivf_scan_quantized``, the reference's own yardstick for
  this kernel.

``kernels/ops.py`` chooses between them by the device of the tensors.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .ivf_scan import extract_topk, mask_through_last_nan, plan_tile_probes

MAX_K2 = 256
MAX_D = 1024
MAX_L = 1024
MAX_SMEM = 232_448          # bytes of shared memory one block may use


def ivf_scan_q8_topk_plain(q8, scale, norm2, centroids, posting_ids, cids,
                           mask, queries, *, k2: int):
    """Plain torch version: ((B, k2) ascending dists, (B, k2) ids).  Each
    query's probes in plan order (ascending cluster, as in the reference's
    tiles), the reference's NaN result (:func:`mask_through_last_nan`),
    then the :func:`extract_topk` merge rule."""
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
    d = mask_through_last_nan(d, live)
    return extract_topk(d.reshape(b, -1), ids.reshape(b, -1), k2)


def _require(cond: bool, msg: str, what: str = "ivf_scan_q8_topk") -> None:
    if not cond:
        raise ValueError(f"{what} kernel: {msg}")


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
    if b == 0:
        return (torch.empty((0, k2), dtype=torch.float32, device=dev),
                torch.empty((0, k2), dtype=torch.int32, device=dev))
    tile_cids, qsel = plan_tile_probes(cids, mask, 1, r_count)
    return ivf_scan_q8_topk_planned(q8, scale, norm2, centroids, posting_ids,
                                    tile_cids, qsel.reshape(b, p), queries,
                                    k2=k2)


def ivf_scan_q8_topk_planned(q8, scale, norm2, centroids, posting_ids,
                             tile_cids, qsel, queries, *, k2: int):
    """Launch K1 on a prebuilt plan: ``tile_cids`` (B, P) and ``qsel``
    (B, P) from :func:`plan_tile_probes` with one query per tile.  The
    inputs' limits are checked by :func:`ivf_scan_q8_topk_cuda`; this
    checks only the plan's shapes.  Returns ((B, k2), (B, k2))."""
    dev = queries.device
    b, p = tile_cids.shape
    _, l, d = q8.shape
    _require(qsel.shape == (b, p) and queries.shape == (b, d)
             and tile_cids.dtype == torch.int32
             and qsel.dtype == torch.int32, "plan shapes")
    qsel = qsel.contiguous()
    tile_cids = tile_cids.contiguous()
    out_d = torch.empty((b, k2), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k2), dtype=torch.int32, device=dev)
    rc = cuda_lib.library().ivf_scan_q8_topk_launch(
        q8.data_ptr(), scale.data_ptr(), norm2.data_ptr(),
        centroids.data_ptr(), posting_ids.data_ptr(), tile_cids.data_ptr(),
        qsel.data_ptr(), queries.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), b, p, l, d, k2, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "ivf_scan_q8_topk")
    cuda_lib.LAUNCHES.add("ivf_scan_q8_topk")
    return out_d, out_i


def ivf_scan_q8_plain(q8, scale, norm2, centroids, cids, mask, queries
                      ) -> torch.Tensor:
    """Plain torch version of B7: (B, P, L) f32, cids clamped, masked
    probes +inf, no id masking (dead slots read ||q - c||^2)."""
    from repro_torch.core.quantize import QuantizedPostings, \
        ivf_scan_quantized

    return ivf_scan_quantized(QuantizedPostings(q8, scale, norm2), centroids,
                              cids, mask, queries)


def ivf_scan_q8_cuda(q8, scale, norm2, centroids, cids, mask, queries
                     ) -> torch.Tensor:
    """Launch B7 on the tensors' CUDA device (current stream).

    Takes q8 (C, L, D) int8, scale (C, 1, 1) f32, norm2 (C, L) f32,
    centroids (C, D) f32, cids (B, P) int32 (clamped to [0, C) in the
    kernel), mask (B, P) bool, queries (B, D) f32, all contiguous on one
    CUDA device, with D % 4 == 0, D <= 1024 and q8 4-byte aligned.
    Anything else raises; nothing falls back to the plain version."""
    def need(cond, msg):
        _require(cond, msg, "ivf_scan_q8")

    dev = queries.device
    need(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    tensors = dict(q8=q8, scale=scale, norm2=norm2, centroids=centroids,
                   cids=cids, mask=mask, queries=queries)
    for name, t in tensors.items():
        need(t.device == dev, f"{name} on {t.device}, queries on {dev}")
        need(t.is_contiguous(), f"{name} is not contiguous")
    need(q8.dtype == torch.int8, "q8 must be int8")
    for name in ("scale", "norm2", "centroids", "queries"):
        need(tensors[name].dtype == torch.float32, f"{name} must be f32")
    need(cids.dtype == torch.int32, "cids must be int32")
    need(mask.dtype == torch.bool, "mask must be bool")
    need(q8.dim() == 3 and q8.shape[0] > 0, f"q8 shape {tuple(q8.shape)}")
    c, l, d = q8.shape
    b, p = cids.shape
    need(scale.shape == (c, 1, 1), f"scale {tuple(scale.shape)}")
    need(norm2.shape == (c, l), f"norm2 {tuple(norm2.shape)}")
    need(centroids.shape == (c, d), "centroids shape")
    need(mask.shape == (b, p), "mask shape")
    need(queries.shape == (b, d), "queries shape")
    need(d % 4 == 0 and 0 < d <= MAX_D, f"D={d} (multiple of 4, <= {MAX_D})")
    need(q8.data_ptr() % 4 == 0, "q8 not 4-byte aligned")
    out = torch.empty((b, p, l), dtype=torch.float32, device=dev)
    if b * p * l == 0:
        return out
    rc = cuda_lib.library().ivf_scan_q8_legacy_launch(
        q8.data_ptr(), scale.data_ptr(), norm2.data_ptr(),
        centroids.data_ptr(), cids.data_ptr(), mask.data_ptr(),
        queries.data_ptr(), out.data_ptr(), b, c, p, l, d,
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "ivf_scan_q8")
    cuda_lib.LAUNCHES.add("ivf_scan_q8")
    return out
