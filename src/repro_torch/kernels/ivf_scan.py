"""Fused f32 posting scans (port of ``repro.kernels.ivf_scan``).

* The deduped probe plan (:func:`plan_tile_probes`) and the top-k2 merge
  rule (:func:`extract_topk`), which the q8 scan shares.
* B2 ``ivf_scan_topk``, the candidate-compressed scan: per tile of ``bq``
  queries, every planned (query, row) distance in the norm form
  ||q||^2 - 2 q.p + ||p||^2 (clamped >= 0), merged into a running top-k2
  unique by id; a NaN distance of a live row empties the query's
  candidates at that slot (:func:`mask_through_last_nan`).
  :func:`ivf_scan_topk_cuda` launches ``csrc/ivf_scan_topk.cu`` (a tile's
  plan split over several blocks, then a merge of their partial top-k2);
  :func:`ivf_scan_topk_plain` computes the same function with the same
  plan and :func:`extract_topk`.
* B6a ``ivf_scan``, the legacy scan: (B, P, L) distances, masked probes
  +inf.  :func:`ivf_scan_cuda` launches ``csrc/ivf_scan.cu``;
  :func:`ivf_scan_plain` is the plain version.
* B6b ``ivf_scan_clustermajor``, the cluster-major legacy scan: (A, L, B)
  distances from every row of each active cluster to every query,
  unselected (cluster, query) pairs +inf.  :func:`ivf_scan_clustermajor_cuda`
  launches ``csrc/ivf_scan_clustermajor.cu``;
  :func:`ivf_scan_clustermajor_plain` is the plain version.

``kernels/ops.py`` chooses between kernel and plain version by the device
of the tensors.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.distance import INF

from . import cuda_lib
from .ref import ivf_scan_clustermajor_ref, ivf_scan_ref

BQ = 8                      # queries per tile of the f32 fused scan
MAX_K2 = 256
MAX_D = 1024
MAX_L = 1024
MAX_SMEM = 232_448          # bytes of shared memory one block may use


def plan_tile_probes(cids: torch.Tensor, mask: torch.Tensor, bq: int,
                     n_clusters: int, *, tile_chunk: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile block table + query-selection mask (plain device code).

    Flattens each tile of ``bq`` queries' (bq, P) probe list to S = bq*P
    slots, sorts by cluster id (dead probes sort to the end) and keeps only
    the first occurrence of each cluster live.  Returns

      tile_cids (B/bq, S) int32 — sorted cluster per slot,
      qsel      (B/bq, S, bq) int32 — nonzero iff query j of the tile probes
                tile_cids[t, s] and s is that cluster's first slot.

    A (query, cluster) pair probed more than once is scanned once.  Tiles are
    processed in chunks that bound the (c, S, bq, P) membership intermediate;
    the plan is bit-identical for any chunk size.
    """
    b, p = cids.shape
    nb = b // bq
    s_len = bq * p
    cl = torch.clamp(cids, 0, n_clusters - 1).to(torch.int32)
    live = mask.bool() & (cids >= 0)
    key = torch.where(live, cl, n_clusters).reshape(nb, s_len)
    sc = torch.sort(key, dim=1).values
    uniq = torch.cat([torch.ones((nb, 1), dtype=torch.bool, device=sc.device),
                      sc[:, 1:] != sc[:, :-1]], dim=1) & (sc < n_clusters)
    cl3 = cl.reshape(nb, bq, p)
    lv3 = live.reshape(nb, bq, p)
    if tile_chunk <= 0:
        tile_chunk = max(1, (1 << 24) // max(s_len * bq * p, 1))
    chunks = []
    for lo in range(0, nb, tile_chunk):
        hi = min(lo + tile_chunk, nb)
        member = torch.any(
            (cl3[lo:hi, None, :, :] == sc[lo:hi, :, None, None])
            & lv3[lo:hi, None, :, :], dim=-1)                  # (c, S, bq)
        chunks.append((member & uniq[lo:hi, :, None]).to(torch.int32))
    qsel = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
    tile_cids = torch.clamp_max(sc, n_clusters - 1).to(torch.int32)
    return tile_cids, qsel


def extract_topk(cat_d: torch.Tensor, cat_i: torch.Tensor, k2: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """k2-pass min extraction with duplicate-id suppression (the merge rule
    of the scan kernels).  cat_d, cat_i: (bq, n).  Each pass emits the
    global minimum (lowest column among equal values) and kills every
    remaining entry with the same id, so the output is ascending and unique
    by id with the per-id minimum; exhausted slots are (+inf, -1)."""
    bq, n = cat_d.shape
    if n == 0:
        return (cat_d.new_full((bq, k2), INF),
                torch.full((bq, k2), -1, dtype=torch.int32,
                           device=cat_d.device))
    col = torch.arange(n, device=cat_d.device).expand(bq, n)
    cat_i = cat_i.to(torch.int64)
    out_d, out_i = [], []
    for _ in range(k2):
        m = torch.min(cat_d, dim=1, keepdim=True).values
        pos = torch.min(torch.where(cat_d == m, col, n), dim=1,
                        keepdim=True).values
        hit = col == pos
        pid = torch.sum(torch.where(hit, cat_i, 0), dim=1, keepdim=True)
        ok = torch.isfinite(m)
        out_d.append(torch.where(ok, m, INF)[:, 0])
        out_i.append(torch.where(ok, pid, -1)[:, 0])
        kill = hit | ((cat_i == pid) & (pid >= 0) & ok)
        cat_d = torch.where(kill, INF, cat_d)
    return (torch.stack(out_d, dim=1),
            torch.stack(out_i, dim=1).to(torch.int32))


def mask_through_last_nan(d: torch.Tensor, live: torch.Tensor
                          ) -> torch.Tensor:
    """The scan kernels' merge input: ``d`` (..., S, L) planned distances in
    plan-slot order, ``live`` (..., S, L) the selected rows with id >= 0.
    Returns ``d`` with every row that is not live, and every row of a slot
    at or before the last slot holding a live NaN, set to +inf.

    This is what the reference's per-slot ``_extract_topk`` makes of a NaN:
    ``jnp.min`` of the buffer and the slot is NaN, so every pass emits
    (+inf, -1) and kills nothing, and the query's buffer leaves that slot
    empty.  Only the slots after it refill it."""
    nan_slot = (live & torch.isnan(d)).any(dim=-1)              # (..., S)
    s_idx = torch.arange(d.shape[-2], device=d.device)
    last = torch.where(nan_slot, s_idx, -1).max(dim=-1, keepdim=True).values
    keep = live & (s_idx > last)[..., None]
    return torch.where(keep, d, INF)


def _pad_tile(cids, mask, queries, bq):
    """Pad the batch to a multiple of ``bq`` with dead queries (zero
    vectors, every probe masked), as the reference's wrapper does."""
    b = queries.shape[0]
    padb = (-b) % bq
    mask = mask.bool()
    if padb:
        queries = torch.cat([queries, queries.new_zeros((padb,
                                                         queries.shape[1]))])
        cids = torch.cat([cids, cids.new_zeros((padb, cids.shape[1]))])
        mask = torch.cat([mask, mask.new_zeros((padb, mask.shape[1]))])
    return cids, mask, queries


def ivf_scan_topk_plain(postings, posting_ids, cids, mask, queries, *,
                        k2: int, bq: int = BQ):
    """Plain torch version of B2: ((B, k2) ascending dists, (B, k2) ids).

    The kernel's structure in tensor form: the tile plan, every planned
    (query, row) distance, rows with id < 0 or unselected queries +inf
    (a select after the product, so a NaN payload in a dead row never
    reaches the merge), the reference's NaN result
    (:func:`mask_through_last_nan`), then the :func:`extract_topk` merge
    rule."""
    b = queries.shape[0]
    r_count, l, _ = postings.shape
    cids, mask, q = _pad_tile(cids, mask, queries.to(torch.float32), bq)
    nb = q.shape[0] // bq
    tile_cids, qsel = plan_tile_probes(cids, mask, bq, r_count)
    s_len = tile_cids.shape[1]
    rows = tile_cids.long()                                   # (nb, S)
    g = postings[rows].to(torch.float32)                      # (nb,S,L,D)
    qt = q.reshape(nb, bq, -1)
    d = (torch.sum(qt * qt, dim=-1)[:, :, None, None]
         - 2.0 * torch.einsum("tjd,tsld->tjsl", qt, g)
         + torch.sum(g * g, dim=-1)[:, None, :, :])           # (nb,bq,S,L)
    d = torch.clamp_min(d, 0.0)
    ids = posting_ids[rows]                                   # (nb, S, L)
    live = (qsel.permute(0, 2, 1) != 0)[:, :, :, None] \
        & (ids >= 0)[:, None, :, :]
    d = mask_through_last_nan(d, live).reshape(nb * bq, s_len * l)
    ids = ids[:, None].expand(nb, bq, s_len, l).reshape(nb * bq, s_len * l)
    od, oi = extract_topk(d, ids, k2)
    return od[:b], oi[:b]


def _require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what} kernel: {msg}")


def _check_common(what, tensors: dict, dev) -> None:
    _require(dev.type == "cuda", what, f"needs CUDA tensors, got {dev}")
    for name, t in tensors.items():
        _require(t.device == dev, what, f"{name} on {t.device}, "
                                        f"queries on {dev}")
        _require(t.is_contiguous(), what, f"{name} is not contiguous")
    _require(tensors["postings"].dtype == torch.float32, what,
             "postings must be f32")
    _require(tensors["queries"].dtype == torch.float32, what,
             "queries must be f32")
    _require(tensors["mask"].dtype == torch.bool, what, "mask must be bool")
    post = tensors["postings"]
    _require(post.dim() == 3 and post.shape[0] > 0, what,
             f"postings shape {tuple(post.shape)}")
    _require(post.data_ptr() % 16 == 0, what, "postings not 16-byte aligned")
    r_count, l, d = post.shape
    b = tensors["queries"].shape[0]
    cids = tensors["cids"]
    _require(cids.dim() == 2 and cids.shape[0] == b, what, "cids shape")
    _require(tensors["mask"].shape == cids.shape, what, "mask shape")
    _require(tensors["queries"].shape == (b, d), what, "queries shape")
    _require(d % 4 == 0 and 0 < d <= MAX_D, what,
             f"D={d} (multiple of 4, <= {MAX_D})")
    _require(0 < l <= MAX_L, what, f"L={l} outside [1, {MAX_L}]")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def b2_chunks(n_tiles: int, s_len: int, k2: int, dev) -> int:
    """How many blocks B2 gives each tile: about four for every SM of the
    card, within the kernel's own limit (``ivf_scan_topk_max_chunks``: at
    least one slot a block, and as many partials as its merge stages)."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    want = -(-4 * _sm_count(index) // max(n_tiles, 1))
    top = cuda_lib.library().ivf_scan_topk_max_chunks(s_len, k2)
    return max(1, min(want, top))


def ivf_scan_topk_cuda(postings, posting_ids, cids, mask, queries, *,
                       k2: int, bq: int = BQ, chunks: int | None = None):
    """Launch B2 on the tensors' CUDA device (current stream).

    Takes postings (R, L, D) f32, posting_ids (R, L) int32, cids (B, P)
    int, mask (B, P) bool, queries (B, D) f32, all contiguous on one CUDA
    device.  Limits: bq == 8, 1 <= k2 <= 256, D % 4 == 0 and D <= 1024,
    L <= 1024, postings 16-byte aligned, and the block's shared memory (a
    chunk of rows plus the tile's queries and buffers) within 227 KB.
    ``chunks`` is a test hook: it splits each tile's plan over that many
    blocks (1 up to the kernel's limit, :func:`b2_chunks`); the serving
    paths pass None, which takes :func:`b2_chunks`.  Anything else raises;
    nothing falls back to the plain version."""
    what = "ivf_scan_topk"
    dev = queries.device
    _check_common(what, dict(postings=postings, posting_ids=posting_ids,
                             cids=cids, mask=mask, queries=queries), dev)
    r_count, l, d = postings.shape
    _require(posting_ids.dtype == torch.int32
             and posting_ids.shape == (r_count, l), what,
             "posting_ids must be (R, L) int32")
    _require(bq == BQ, what, f"bq={bq}: the kernel tiles {BQ} queries")
    _require(1 <= k2 <= MAX_K2, what, f"k2={k2} outside [1, {MAX_K2}]")
    lib = cuda_lib.library()
    smem = lib.ivf_scan_topk_smem_bytes(l, d, k2)
    _require(smem <= MAX_SMEM, what, f"needs {smem} B of shared memory")
    b = queries.shape[0]
    if b == 0:
        return (torch.empty((0, k2), dtype=torch.float32, device=dev),
                torch.empty((0, k2), dtype=torch.int32, device=dev))
    pc, pm, pq = _pad_tile(cids, mask, queries, bq)
    tile_cids, qsel = plan_tile_probes(pc, pm, bq, r_count)
    out_d, out_i = ivf_scan_topk_planned(postings, posting_ids, tile_cids,
                                         qsel, pq, k2=k2, chunks=chunks)
    return out_d[:b], out_i[:b]


def ivf_scan_topk_planned(postings, posting_ids, tile_cids, qsel, queries,
                          *, k2: int, chunks: int | None = None):
    """Launch B2 on a prebuilt plan: ``tile_cids`` (B/8, S) and ``qsel``
    (B/8, S, 8) from :func:`plan_tile_probes`, ``queries`` (B, D) padded to
    whole tiles, ``chunks`` blocks a tile (a test hook; None:
    :func:`b2_chunks`).  The inputs' limits are checked by
    :func:`ivf_scan_topk_cuda`; this checks only the plan's shapes and
    ``chunks``.  Returns the padded ((B, k2), (B, k2))."""
    what = "ivf_scan_topk"
    dev = queries.device
    nb, s_len = tile_cids.shape
    _, l, d = postings.shape
    _require(queries.shape == (nb * BQ, d) and qsel.shape == (nb, s_len, BQ)
             and tile_cids.dtype == torch.int32
             and qsel.dtype == torch.int32, what, "plan shapes")
    if chunks is None:
        chunks = b2_chunks(nb, s_len, k2, dev)
    top = cuda_lib.library().ivf_scan_topk_max_chunks(s_len, k2)
    _require(1 <= chunks <= top, what,
             f"chunks={chunks} outside [1, {top}] (S={s_len}, k2={k2})")
    tile_cids = tile_cids.contiguous()
    qsel = qsel.contiguous()
    queries = queries.contiguous()
    out_d = torch.empty((nb * BQ, k2), dtype=torch.float32, device=dev)
    out_i = torch.empty((nb * BQ, k2), dtype=torch.int32, device=dev)
    part = (torch.empty((nb * BQ, chunks, k2), dtype=torch.float32,
                        device=dev),
            torch.empty((nb * BQ, chunks, k2), dtype=torch.int32, device=dev),
            torch.empty((nb * BQ, chunks), dtype=torch.int32, device=dev)) \
        if chunks > 1 else None
    pd, pi, pn = (t.data_ptr() for t in part) if part else (0, 0, 0)
    rc = cuda_lib.library().ivf_scan_topk_launch(
        postings.data_ptr(), posting_ids.data_ptr(), tile_cids.data_ptr(),
        qsel.data_ptr(), queries.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), pd, pi, pn, nb, s_len, l, d, k2, chunks,
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, what)
    cuda_lib.LAUNCHES.add(what)
    return out_d, out_i


def ivf_scan_plain(postings, cids, mask, queries) -> torch.Tensor:
    """Plain torch version of B6a: (B, P, L) f32, masked probes +inf.  The
    kernel computes each (query, probe) block in the norm form, which is
    exactly the oracle's formula."""
    return ivf_scan_ref(postings, cids, mask, queries)


def ivf_scan_cuda(postings, cids, mask, queries) -> torch.Tensor:
    """Launch B6a on the tensors' CUDA device (current stream).

    Takes postings (C, L, D) f32, cids (B, P) int32 (clamped to [0, C) in
    the kernel), mask (B, P) bool, queries (B, D) f32, contiguous on one
    CUDA device, with D % 4 == 0, D <= 1024, L <= 1024 and postings 16-byte
    aligned.  Anything else raises; nothing falls back."""
    what = "ivf_scan"
    dev = queries.device
    _check_common(what, dict(postings=postings, cids=cids, mask=mask,
                             queries=queries), dev)
    _require(cids.dtype == torch.int32, what, "cids must be int32")
    c, l, d = postings.shape
    b, p = cids.shape
    lib = cuda_lib.library()
    out = torch.empty((b, p, l), dtype=torch.float32, device=dev)
    if b * p == 0:
        return out
    rc = lib.ivf_scan_launch(postings.data_ptr(), cids.data_ptr(),
                             mask.data_ptr(), queries.data_ptr(),
                             out.data_ptr(), b, c, p, l, d,
                             cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, what)
    cuda_lib.LAUNCHES.add(what)
    return out


def ivf_scan_clustermajor_plain(postings, active, qsel, queries
                                ) -> torch.Tensor:
    """Plain torch version of B6b: (A, L, B) f32, unselected pairs +inf.
    The kernel computes each (row, query) distance in the oracle's norm
    form, so the oracle is the plain version."""
    return ivf_scan_clustermajor_ref(postings, active, qsel, queries)


def ivf_scan_clustermajor_cuda(postings, active, qsel, queries
                               ) -> torch.Tensor:
    """Launch B6b on the tensors' CUDA device (current stream).

    Takes postings (C, L, D) f32, active (A,) int32 (clamped to [0, C) in
    the kernel), qsel (A, B) bool, queries (B, D) f32, contiguous on one
    CUDA device.  Any D and L; anything else raises, nothing falls back."""
    what = "ivf_scan_clustermajor"
    dev = queries.device
    tensors = dict(postings=postings, active=active, qsel=qsel,
                   queries=queries)
    _require(dev.type == "cuda", what, f"needs CUDA tensors, got {dev}")
    for name, t in tensors.items():
        _require(t.device == dev, what, f"{name} on {t.device}, "
                                        f"queries on {dev}")
        _require(t.is_contiguous(), what, f"{name} is not contiguous")
    _require(postings.dtype == torch.float32, what, "postings must be f32")
    _require(queries.dtype == torch.float32, what, "queries must be f32")
    _require(active.dtype == torch.int32, what, "active must be int32")
    _require(qsel.dtype == torch.bool, what, "qsel must be bool")
    _require(postings.dim() == 3 and postings.shape[0] > 0, what,
             f"postings shape {tuple(postings.shape)}")
    c, l, d = postings.shape
    b = queries.shape[0]
    a = active.shape[0]
    _require(active.dim() == 1, what, "active must be (A,)")
    _require(qsel.shape == (a, b), what, "qsel shape")
    _require(queries.dim() == 2 and queries.shape[1] == d, what,
             "queries shape")
    out = torch.empty((a, l, b), dtype=torch.float32, device=dev)
    if a * l * b == 0:
        return out
    rc = cuda_lib.library().ivf_scan_clustermajor_launch(
        postings.data_ptr(), active.data_ptr(), qsel.data_ptr(),
        queries.data_ptr(), out.data_ptr(), a, c, l, b, d,
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, what)
    cuda_lib.LAUNCHES.add(what)
    return out
