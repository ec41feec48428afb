"""Double-buffered prefetch pipeline (port of ``repro.runtime.pipeline``).

Three modes over one index: streamed from the q8 host tier
(``QuantizedTieredPostings``, the serving default), streamed from the f32
host tier (``TieredPostings``), or resident (``tier=None``: the whole index
on the device, served through ``core.search._scan_and_rank``).

Stage protocol (each stage returns a handle consumed by the next):

  ``plan``     -> centroid scan + LLSP routing/pruning on the device, probe
                  set resolved to host arrays (or an admission-time
                  ``routed`` plan reused as it is);
  ``prefetch`` -> streamed: host gather of the probed-cluster union into
                  pinned buffers + copy to the device on the tier's stream,
                  on a dedicated worker thread; resident: nothing;
  ``dispatch`` -> join the gather, launch the fused scan (K1 for q8, B2 for
                  f32) and the candidate merge on the scan stream, which
                  first waits on the copy's event; with a ``fresh_source``
                  attached, capture one freshness snapshot and chain the
                  §6.2 delta + tombstone merge (``core.fresh.merge_fresh``)
                  onto the scan; results start copying back to pinned host
                  buffers; returns without waiting;
  ``harvest``  -> wait for the scan's event, exact re-rank from the flash
                  tier (numpy) with adaptive stop when one is attached.

CUDA streams: ``plan`` runs on the current stream, the tier copies on its
own stream, the scan on the pipeline's scan stream.  Tensors used on a
stream other than the one that allocated them are marked with
``record_stream`` so the allocator cannot hand their memory out while the
scan still reads them.  Batch i+1 is planned before batch i's scan is
dispatched (``run_pipelined``), as in the reference.

Every stage is wall-clock stamped (:class:`StageTimes`) so
:func:`overlap_efficiency` and :func:`rerank_overlap_efficiency` measure the
overlap from the stamps.  On the CPU (``device="cpu"``) the same stages run
the kernels' plain versions with no streams.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.distance import (
    dedup_topk, merge_candidate_topk, squared_l2, topk_smallest,
)
from repro_torch.core.fresh import merge_fresh
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.search import SearchConfig, _auto_ncand, \
    _scan_and_rank, decide_nprobe
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.obs.quality import recall_proxy
from repro_torch.storage.flash_tier import FlashTier
from repro_torch.storage.host_tier import QuantizedTieredPostings, \
    TieredPostings


@dataclasses.dataclass
class StageTimes:
    """Wall-clock stamps of one batch through the pipeline (seconds)."""
    size: int = 0                  # true batch size (pre-padding)
    rows: int = 0                  # packed posting rows streamed
    plan_start: float = 0.0
    plan_end: float = 0.0
    gather_start: float = 0.0
    gather_end: float = 0.0        # host union gather materialized
    stream_end: float = 0.0        # packed tensors on device
    scan_dispatch: float = 0.0
    scan_done: float = 0.0
    routed: bool = False           # plan reused an admission-time route
    clusters_requested: int = 0    # probe slots across the batch (pre-dedup)
    union_clusters: int = 0        # deduped gather-union size
    union_bytes: int = 0           # payload bytes of the union
    rerank_start: float = 0.0
    rerank_end: float = 0.0
    rerank_io_s: float = 0.0       # seconds spent inside flash read bursts
    rerank_rounds: int = 0         # adaptive-stop rounds actually executed
    rerank_cands: int = 0          # candidates exact-scored before the stop
    rerank_stable_stop: bool = False  # top-k went stable before the
                                      # candidate list was exhausted
    rerank_round_size: int = 0     # round width this batch used

    @property
    def total(self) -> float:
        end = self.rerank_end if self.rerank_end > 0.0 else self.scan_done
        return end - self.plan_start


@dataclasses.dataclass
class BatchResult:
    ids: np.ndarray                # (b, k) int32
    dists: np.ndarray              # (b, k) float32
    nprobe: np.ndarray             # (b,) int32
    times: StageTimes
    fresh_seq: int = -1            # freshness snapshot this batch scanned
                                   # against (-1 = no fresh view attached)
    partial: Optional[np.ndarray] = None   # (b,) bool: answered from an
                                           # incomplete shard set; None =
                                           # complete (always, single node)
    partial_reason: str = "no_replica"     # why the shard set was incomplete
    quality: Optional[np.ndarray] = None   # (b,) rerank-agreement recall
                                           # proxy; None = no re-rank ran
    shards: Optional[np.ndarray] = None    # (b,) int32 primary shard per
                                           # query (sharded serving only)


@dataclasses.dataclass
class _Plan:
    queries_dev: torch.Tensor      # (bp, D) padded, on device
    cids: np.ndarray               # (bp, P)
    pmask: np.ndarray              # (bp, P) bool
    nprobe: np.ndarray             # (bp,)
    times: StageTimes
    queries_host: np.ndarray       # (bp, D) for the flash re-rank
    ready: Optional[torch.cuda.Event] = None


@dataclasses.dataclass
class _Prep:
    plan: _Plan
    fut: Optional[object]          # gather future (None when resident)


@dataclasses.dataclass
class _Inflight:
    out_d: torch.Tensor            # (bp, k) on the host (pinned on CUDA)
    out_i: torch.Tensor
    nprobe: np.ndarray
    times: StageTimes
    size: int
    queries_host: np.ndarray
    done: Optional[torch.cuda.Event] = None
    fresh_seq: int = -1            # freshness snapshot merged (-1 = none)


@dataclasses.dataclass(frozen=True)
class RerankConfig:
    """FusionANNS-style adaptive re-rank over the flash tier: candidates
    (ascending by q8 distance) are exact-scored in rounds of
    ``round_size``; once the batch's exact top-k survives ``stable_rounds``
    rounds unchanged the walk stops."""
    round_size: int = 64
    stable_rounds: int = 1


def max_id_replicas(posting_ids) -> int:
    """Largest number of posting slots any single id occupies (the build's
    realized closure replication): the safe ``dup_bound`` of the oracle's
    pre-selection."""
    ids = np.asarray(posting_ids).ravel()
    ids = ids[ids >= 0]
    if ids.size == 0:
        return 1
    return int(np.bincount(ids).max())


def _scan_streamed_q8(packed_q8, packed_scale, packed_norm2, packed_cent,
                      packed_ids, remap, pmask, queries, cfg: SearchConfig,
                      *, dup_bound: int):
    """Candidate-compressed scan over the streamed int8-residual rows.

    ``use_kernel``: the fused scan (K1 on CUDA, its plain version on the
    CPU) runs on the packed tensors with remap as cids.  Otherwise the
    packed-domain oracle, the explicit A/B arm: one int8->f32 product over
    all packed rows plus the closed-form residual correction, each query
    masked to its probed rows, top-k over an O(k2 * dup_bound)
    pre-selection, then dedup."""
    k2 = cfg.n_cand or _auto_ncand(cfg.k)
    if cfg.use_kernel:
        cd, ci = kops.ivf_scan_q8_topk(
            packed_q8, packed_scale, packed_norm2, packed_cent, packed_ids,
            remap, pmask, queries, k2=k2)
    else:
        r, l, _ = packed_q8.shape
        b = queries.shape[0]
        g8 = packed_q8.to(torch.float32)                         # (R, L, D)
        qc = queries[:, None, :] - packed_cent[None, :, :]       # (B, R, D)
        cross = torch.einsum("brd,rld->brl", qc, g8)             # (B, R, L)
        s = packed_scale[:, 0, 0][None, :, None]
        d = (torch.sum(qc * qc, dim=-1)[:, :, None]
             - 2.0 * s * cross + packed_norm2[None, :, :])
        d = torch.clamp_min(d, 0.0).reshape(b, r * l)
        member = torch.zeros((b, r), dtype=torch.int32, device=d.device)
        rows_idx = torch.arange(b, device=d.device)[:, None].expand_as(remap)
        member.index_put_((rows_idx, remap.long()), pmask.to(torch.int32),
                          accumulate=True)
        live = (member > 0)[:, :, None] & (packed_ids >= 0)[None, :, :]
        d = torch.where(live.reshape(b, r * l), d, float("inf"))
        ids = packed_ids.reshape(1, r * l).expand(b, r * l)
        nd, pos = topk_smallest(d, min(k2 * dup_bound, r * l))
        cd, ci = dedup_topk(nd, torch.gather(ids, 1, pos), k2)
    return merge_candidate_topk(cd, ci, cfg.k)


def _scan_streamed(packed, packed_ids, remap, pmask, queries,
                   cfg: SearchConfig, *, dup_bound: int):
    """Candidate-compressed scan over the streamed f32 rows.

    ``use_kernel``: the fused scan (B2 on CUDA, its plain version on the
    CPU) runs on the packed tensors with remap as cids.  Otherwise the
    packed-domain oracle, the explicit A/B arm: one product of the batch
    against every packed row, each query masked to its probed rows with a
    select after the product (so a NaN payload in a dead row never reaches
    the top-k), top-k over an O(k2 * dup_bound) pre-selection, then
    dedup."""
    k2 = cfg.n_cand or _auto_ncand(cfg.k)
    if cfg.use_kernel:
        cd, ci = kops.ivf_scan_topk(packed, packed_ids, remap, pmask,
                                    queries, k2=k2)
    else:
        r, l, dim = packed.shape
        b = queries.shape[0]
        d = squared_l2(queries, packed.reshape(r * l, dim))     # (B, R*L)
        member = torch.zeros((b, r), dtype=torch.int32, device=d.device)
        rows_idx = torch.arange(b, device=d.device)[:, None].expand_as(remap)
        member.index_put_((rows_idx, remap.long()), pmask.to(torch.int32),
                          accumulate=True)
        live = (member > 0)[:, :, None] & (packed_ids >= 0)[None, :, :]
        d = torch.where(live.reshape(b, r * l), d, float("inf"))
        ids = packed_ids.reshape(1, r * l).expand(b, r * l)
        nd, pos = topk_smallest(d, min(k2 * dup_bound, r * l))
        cd, ci = dedup_topk(nd, torch.gather(ids, 1, pos), k2)
    return merge_candidate_topk(cd, ci, cfg.k)


def _scan_reference(packed, packed_ids, remap, pmask, queries,
                    cfg: SearchConfig):
    """The pre-runtime streamed scan (A/B baseline): the fused scan's
    oracle on the packed tensors, which re-gathers a (B, P, L, D) probe
    tensor from the rows the tier just streamed."""
    from repro_torch.kernels.ref import ivf_scan_topk_ref

    k2 = cfg.n_cand or _auto_ncand(cfg.k)
    cd, ci = ivf_scan_topk_ref(packed, packed_ids, remap, pmask, queries,
                               k2=k2)
    return merge_candidate_topk(cd, ci, cfg.k)


class PrefetchPipeline:
    """Stage-structured serving over one index.

    Streamed (``tier`` given, q8 or f32): postings live on the host and each
    batch streams only its probed-cluster union.  Resident (``tier=None``):
    the index is on the device and prefetch does nothing.  ``pad_batch`` /
    ``row_bucket`` quantize the padded batch size and packed-row count as in
    the reference.  ``fresh_source`` is a zero-argument callable returning
    the current ``lifecycle.ingest.FreshSnapshot`` (or None): when set, each
    batch captures one snapshot at dispatch and merges the delta buffer and
    tombstones into its candidates, and the scan over-fetches (n_cand-wide
    candidates instead of k) so tombstoned slots cannot starve the final
    top-k.  Runs on ``device`` (the CUDA card by default; ``"cpu"`` runs the
    plain versions)."""

    def __init__(self, index: IVFIndex, llsp_params, cfg: SearchConfig,
                 tier: Optional[Union[QuantizedTieredPostings,
                                      TieredPostings]] = None, *,
                 pad_batch: int = 16, row_bucket: int = 256,
                 dup_bound: Optional[int] = None,
                 fresh_source=None,
                 flash: Optional[FlashTier] = None,
                 rerank: Optional[RerankConfig] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.fresh_source = fresh_source
        self.index = index.to(self.device)
        self.llsp_params = (None if llsp_params is None
                            else llsp_params.to(self.device))
        self.cfg = cfg
        self.tier = tier
        self.flash = flash
        self.rerank = rerank if rerank is not None else (
            RerankConfig() if flash is not None else None)
        self.pad_batch = pad_batch
        self.row_bucket = row_bucket
        if dup_bound is None:
            dup_bound = max_id_replicas(
                tier.posting_ids if tier is not None
                else self.index.posting_ids.cpu().numpy())
        self.dup_bound = max(int(dup_bound), 1)
        self._gatherer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="prefetch")
        # rerank reads get their own single-lane queue so batch i's flash
        # I/O does not wait behind batch i+1's union gather
        self._reranker = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rerank")
            if flash is not None else None)
        self._scan_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def close(self) -> None:
        """Stop the worker threads (idempotent)."""
        self._gatherer.shutdown(wait=True)
        if self._reranker is not None:
            self._reranker.shutdown(wait=True)

    @property
    def _scan_cfg(self) -> SearchConfig:
        """With a fresh view attached or the flash re-rank on, the scan
        keeps n_cand-wide candidates (not k): the tombstone filter must not
        starve the final merge, and the re-ranker needs the full ~2k
        candidate set.  n_cand is pinned too, so the scan does not derive a
        wider auto width from the widened k."""
        if self.fresh_source is None and self.flash is None:
            return self.cfg
        k2 = self.cfg.n_cand or _auto_ncand(self.cfg.k)
        return dataclasses.replace(self.cfg, k=k2, n_cand=k2)

    @property
    def streamed(self) -> bool:
        return self.tier is not None

    @property
    def quantized(self) -> bool:
        return getattr(self.tier, "quantized", False) \
            or (self.cfg.tier == "q8" and self.tier is None)

    @property
    def tier_kind(self) -> str:
        """The first-pass payload: "q8" or "f32"."""
        return "q8" if self.quantized else "f32"

    # -- stages ------------------------------------------------------------
    def _padded_inputs(self, queries, topk):
        """Pad (queries, topk) to the batch quantum by repeating the last
        row; returns (q (bp, D), tk (bp,), true b)."""
        q = np.asarray(queries, np.float32)
        tk = np.array(np.broadcast_to(np.asarray(topk, np.int32), (len(q),)))
        b = len(q)
        bp = -(-b // self.pad_batch) * self.pad_batch
        if bp != b:
            q = np.concatenate([q, np.repeat(q[-1:], bp - b, axis=0)])
            tk = np.concatenate([tk, np.repeat(tk[-1:], bp - b)])
        return np.ascontiguousarray(q), np.ascontiguousarray(tk), b

    def _plan_device(self, qd: torch.Tensor, tk: torch.Tensor):
        d = squared_l2(qd, self.index.centroids)
        cdists, cids = topk_smallest(
            d, min(self.cfg.nprobe_max, self.index.n_clusters))
        nprobe = decide_nprobe(self.cfg, self.llsp_params, qd, tk, cdists)
        return cids.to(torch.int32), nprobe

    def route(self, queries: np.ndarray, topk
              ) -> tuple[np.ndarray, np.ndarray]:
        """Admission-time probe routing: the plan stage's centroid scan +
        LLSP decision only, as host arrays ``(cids (b, P), nprobe (b,))``."""
        q, tk, b = self._padded_inputs(queries, topk)
        cids, nprobe = self._plan_device(
            torch.from_numpy(q).to(self.device),
            torch.from_numpy(tk).to(self.device))
        return cids.cpu().numpy()[:b], nprobe.cpu().numpy()[:b]

    def plan(self, queries: np.ndarray, topk,
             nprobe_cap: Optional[np.ndarray] = None,
             routed: Optional[tuple] = None) -> _Plan:
        """Centroid scan + LLSP pruning; probe set resolved to host arrays
        (the only device-to-host wait of the plan stage).

        ``nprobe_cap`` (b,) caps each query's nprobe (0 = uncapped).
        ``routed`` is an admission-time plan ``(cids (b, P), nprobe (b,))``
        from :meth:`route`: when given, the centroid scan is skipped and the
        stage is host bookkeeping only (pad + mask)."""
        t = StageTimes(size=len(queries))
        t.plan_start = time.perf_counter()
        q, tk, b = self._padded_inputs(queries, topk)
        bp = len(q)
        qd = torch.from_numpy(q).to(self.device)
        if routed is not None:
            rcids, rnp = routed
            rcids = np.asarray(rcids, np.int32)
            cids = np.full((bp, rcids.shape[1]), -1, np.int32)
            cids[:b] = rcids
            nprobe = np.zeros((bp,), np.int32)
            nprobe[:b] = np.asarray(rnp, np.int32)
            t.routed = True
        else:
            cd, npd = self._plan_device(qd,
                                        torch.from_numpy(tk).to(self.device))
            cids = cd.cpu().numpy()
            nprobe = npd.cpu().numpy().copy()
        if nprobe_cap is not None:
            cap = np.zeros((bp,), np.int32)
            cap[:b] = np.asarray(nprobe_cap, np.int32)
            capped = cap > 0
            nprobe[capped] = np.minimum(nprobe[capped], cap[capped])
        nprobe[b:] = 0                     # padding rows probe nothing
        pmask = (np.arange(cids.shape[1])[None, :] < nprobe[:, None]) \
            & (cids >= 0)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        t.plan_end = time.perf_counter()
        return _Plan(qd, cids, pmask, nprobe, t, q, ready)

    def _gather(self, plan: _Plan):
        fetched = self.tier.fetch(plan.cids, plan.pmask,
                                  bucket=self.row_bucket)
        ev = self.tier.stats.events[-1]    # same thread as the fetch: safe
        t = plan.times
        t.gather_start = ev.gather_start
        t.gather_end = ev.gather_end
        t.stream_end = ev.stream_end
        t.rows = ev.rows
        t.clusters_requested = ev.clusters_requested
        t.union_clusters = ev.clusters_union
        t.union_bytes = ev.union_bytes
        return fetched

    def prefetch(self, plan: _Plan) -> _Prep:
        """Start the host gather + device copy on the worker thread
        (resident: nothing to fetch)."""
        if not self.streamed:
            return _Prep(plan, None)
        return _Prep(plan, self._gatherer.submit(self._gather, plan))

    def dispatch(self, prep: _Prep, *, reference: bool = False
                 ) -> _Inflight:
        """Join the gather, launch the scan on the scan stream and start the
        copy of its results to the host; returns without waiting.
        ``reference`` swaps in the pre-runtime scan on the f32 tier (the
        A/B baseline)."""
        plan = prep.plan
        t = plan.times
        fetched = prep.fut.result() if self.streamed else None
        quant = getattr(self.tier, "quantized", False)
        if reference and (quant or not self.streamed):
            raise ValueError(
                "reference scan is an f32-tier A/B baseline; the quantized "
                "tier and the resident mode have no pre-runtime twin")
        t.scan_dispatch = time.perf_counter()
        stream = self._scan_stream
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        done = None
        with ctx:
            if stream is not None:
                stream.wait_event(plan.ready)
                plan.queries_dev.record_stream(stream)
                if fetched is not None:
                    stream.wait_event(fetched.ready)
                    for x in fetched.tensors():
                        x.record_stream(stream)
            pmask = torch.from_numpy(plan.pmask).to(self.device)
            if fetched is None:
                cids = torch.from_numpy(plan.cids).to(self.device)
                od, oi = _scan_and_rank(self.index, plan.queries_dev, cids,
                                        pmask, self._scan_cfg)
            elif quant:
                od, oi = _scan_streamed_q8(
                    *fetched.tensors(), pmask, plan.queries_dev,
                    self._scan_cfg, dup_bound=self.dup_bound)
            elif reference:
                od, oi = _scan_reference(*fetched.tensors(), pmask,
                                         plan.queries_dev, self._scan_cfg)
            else:
                od, oi = _scan_streamed(
                    *fetched.tensors(), pmask, plan.queries_dev,
                    self._scan_cfg, dup_bound=self.dup_bound)
            seq = -1
            snap = self.fresh_source() if self.fresh_source is not None \
                else None
            if snap is not None:
                if stream is not None:
                    for x in (snap.delta_vecs, snap.delta_ids,
                              snap.tombstone):
                        x.record_stream(stream)
                # with the re-ranker on, stay candidate-wide through the
                # merge: the narrowing to k happens after rescoring
                keep = self._scan_cfg.k if self.flash is not None \
                    else self.cfg.k
                od, oi = merge_fresh(od, oi, plan.queries_dev,
                                     snap.delta_vecs, snap.delta_ids,
                                     snap.tombstone, keep)
                seq = snap.seq
            if stream is not None:
                host_d = torch.empty(od.shape, dtype=od.dtype,
                                     pin_memory=True)
                host_i = torch.empty(oi.shape, dtype=oi.dtype,
                                     pin_memory=True)
                host_d.copy_(od, non_blocking=True)
                host_i.copy_(oi, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
                od, oi = host_d, host_i
        return _Inflight(od, oi, plan.nprobe, t, t.size, plan.queries_host,
                         done, fresh_seq=seq)

    def harvest(self, infl: _Inflight) -> BatchResult:
        """Wait for the scan; truncate padding; with the flash tier
        attached, exact-rescore the candidates (runs while the next batch's
        scan is in flight under the pipelined drivers)."""
        if infl.done is not None:
            infl.done.synchronize()
        ids = infl.out_i.numpy()[: infl.size]
        dists = infl.out_d.numpy()[: infl.size]
        infl.times.scan_done = time.perf_counter()
        quality = None
        if self.flash is not None and infl.size > 0:
            pre_top = ids[:, : self.cfg.k].copy()
            dists, ids = self._rerank(
                infl.queries_host[: infl.size], dists, ids, infl.times)
            quality = recall_proxy(pre_top, ids, self.cfg.k)
        else:
            ids, dists = ids.copy(), dists.copy()
        return BatchResult(ids, dists, infl.nprobe[: infl.size].copy(),
                           infl.times, fresh_seq=infl.fresh_seq,
                           quality=quality)

    def _rerank(self, queries: np.ndarray, cand_d: np.ndarray,
                cand_i: np.ndarray, t: StageTimes
                ) -> tuple[np.ndarray, np.ndarray]:
        """Flash-tier exact re-rank with adaptive stop (numpy, host).

        Rounds of ``rerank.round_size`` candidate columns are exact-scored
        from the flash tier; each round's read is issued one round ahead on
        the rerank queue.  Ids outside the flash tier and padding (-1) keep
        their incoming distance: a fresh-delta id is already exact from
        the merge.  Stops once the batch's exact top-k survives
        ``stable_rounds`` rounds unchanged."""
        rc = self.rerank
        k = self.cfg.k
        n = cand_i.shape[1]
        t.rerank_start = time.perf_counter()
        exact = np.array(cand_d, np.float32, copy=True)
        step = max(int(rc.round_size), 1)
        t.rerank_round_size = step
        n_rounds = -(-n // step)
        futs: dict[int, object] = {}

        # only ids inside the flash tier are read: a fresh-delta id (past
        # the tier's last row) keeps its exact distance from the merge
        flash_ids = np.where(cand_i < self.flash.n, cand_i, -1)

        def _submit(r):
            if r < n_rounds and r not in futs:
                futs[r] = self._reranker.submit(
                    self.flash.read, flash_ids[:, r * step:(r + 1) * step])

        prev_top = None
        stable = 0
        rounds = 0
        hi = 0
        _submit(0)
        for r in range(n_rounds):
            _submit(r + 1)                 # double-buffer the next read
            uids, rows = futs.pop(r).result()
            ev = self.flash.stats.events[-1]
            t.rerank_io_s += ev.end - ev.start
            lo, hi = r * step, min(n, (r + 1) * step)
            cols = cand_i[:, lo:hi]
            in_flash = (cols >= 0) & (cols < self.flash.n)
            if uids.size:
                pos = np.searchsorted(uids, np.clip(cols, 0, None))
                pos = np.clip(pos, 0, uids.size - 1)
                hit = in_flash & (uids[pos] == np.clip(cols, 0, None))
                vecs = rows[pos]                       # (b, w, D)
                d = np.sum((queries[:, None, :] - vecs) ** 2, axis=-1)
                exact[:, lo:hi] = np.where(hit, d, exact[:, lo:hi])
            rounds = r + 1
            if hi >= k:
                part = np.argpartition(exact[:, :hi], k - 1, axis=1)[:, :k]
                rowd = np.take_along_axis(exact[:, :hi], part, axis=1)
                order = np.argsort(rowd, axis=1, kind="stable")
                sel = np.take_along_axis(part, order, axis=1)
                top = np.take_along_axis(cand_i[:, :hi], sel, axis=1)
                if prev_top is not None and np.array_equal(top, prev_top):
                    stable += 1
                    if stable >= max(int(rc.stable_rounds), 1):
                        t.rerank_stable_stop = hi < n
                        break
                else:
                    stable = 0
                prev_top = top
        for f in futs.values():            # a speculative read may be queued
            f.cancel()
        hi = max(hi, min(n, k))
        part = np.argpartition(exact[:, :hi], min(k, hi) - 1, axis=1)[:, :k]
        rowd = np.take_along_axis(exact[:, :hi], part, axis=1)
        order = np.argsort(rowd, axis=1, kind="stable")
        sel = np.take_along_axis(part, order, axis=1)
        out_d = np.take_along_axis(exact[:, :hi], sel, axis=1)
        out_i = np.take_along_axis(cand_i[:, :hi], sel, axis=1)
        t.rerank_rounds = rounds
        t.rerank_cands = int(hi)
        t.rerank_end = time.perf_counter()
        return out_d, out_i

    def warmup(self, batch_sizes=(16, 32)) -> int:
        """Build the kernel library and run one plan + scan per padded batch
        size (with a fresh view attached, the freshness merge too), so
        traffic never pays the first-use costs (kernel build, allocator
        growth, pinned-buffer pool).  Returns the number of warm
        batches."""
        first = self.index.centroids[:1].cpu().numpy()
        n = 0
        for b in batch_sizes:
            bp = -(-b // self.pad_batch) * self.pad_batch
            self.serve_batch(np.repeat(first, bp, axis=0), self.cfg.k)
            n += 1
        return n

    # -- convenience drivers ----------------------------------------------
    def serve_batch(self, queries, topk,
                    nprobe_cap: Optional[np.ndarray] = None) -> BatchResult:
        plan = self.plan(queries, topk, nprobe_cap=nprobe_cap)
        return self.harvest(self.dispatch(self.prefetch(plan)))

    def run_sequential(self, batches, *, reference: bool = False
                       ) -> list[BatchResult]:
        """Strictly serial stage chain per batch (the A/B baseline);
        ``reference=True`` also swaps in the pre-runtime scan (f32 tier)."""
        out = []
        for queries, topk in batches:
            prep = self.prefetch(self.plan(queries, topk))
            if prep.fut is not None:
                prep.fut.result()          # block: no overlap, by design
            out.append(self.harvest(self.dispatch(prep,
                                                  reference=reference)))
        return out

    def run_pipelined(self, batches, *, depth: int = 1) -> list[BatchResult]:
        """N-deep pipelining: the next batch is planned before the prepared
        batch's scan is dispatched, then gathered/streamed while up to
        ``depth`` scans are in flight."""
        batches = list(batches)
        if not batches:
            return []
        depth = max(int(depth), 1)
        out: list[BatchResult] = []
        inflight: collections.deque = collections.deque()
        prep = self.prefetch(self.plan(*batches[0]))
        i = 1
        while prep is not None or inflight:
            if prep is not None and len(inflight) < depth:
                nxt = self.plan(*batches[i]) if i < len(batches) else None
                i += 1
                inflight.append(self.dispatch(prep))
                prep = self.prefetch(nxt) if nxt is not None else None
            else:
                out.append(self.harvest(inflight.popleft()))
        return out


def inflight_depth(times: list[StageTimes]) -> int:
    """Peak number of batches simultaneously in flight, from the stamps: a
    batch is in flight from its scan dispatch to its harvest."""
    events: list[tuple[float, int]] = []
    for t in times:
        if t.scan_done > t.scan_dispatch:
            events.append((t.scan_dispatch, 1))
            events.append((t.scan_done, -1))
    events.sort()
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


def overlap_efficiency(times: list[StageTimes]) -> float:
    """Fraction of gather+stream seconds hidden under the previous batch's
    scan-in-flight window (0 = fully serial, ~1 = fully hidden)."""
    tot = 0.0
    hidden = 0.0
    for prev, cur in zip(times, times[1:]):
        g0, g1 = cur.gather_start, cur.stream_end
        if g1 <= g0:
            continue
        tot += g1 - g0
        s0, s1 = prev.scan_dispatch, prev.scan_done
        hidden += max(0.0, min(g1, s1) - max(g0, s0))
    return hidden / tot if tot > 0 else 0.0


def stage_spans(t: StageTimes) -> list[tuple[str, float, float]]:
    """(name, t0, t1) trace spans of one batch, from the stamps StageTimes
    already holds (no extra clock reads).  Unstamped stages drop out."""
    spans = [("plan", t.plan_start, t.plan_end),
             ("gather", t.gather_start, t.gather_end),
             ("stream", t.gather_end, t.stream_end),
             ("scan", t.scan_dispatch, t.scan_done),
             ("rerank", t.rerank_start, t.rerank_end)]
    return [(n, a, b) for n, a, b in spans if b > a > 0.0]


def rerank_overlap_efficiency(times: list[StageTimes]) -> float:
    """Fraction of batch i's re-rank seconds inside batch i+1's
    scan-in-flight window; 0.0 when nothing re-ranked or followed."""
    tot = 0.0
    hidden = 0.0
    for cur, nxt in zip(times, times[1:]):
        r0, r1 = cur.rerank_start, cur.rerank_end
        if r1 <= r0:
            continue
        tot += r1 - r0
        s0, s1 = nxt.scan_dispatch, nxt.scan_done
        hidden += max(0.0, min(r1, s1) - max(r0, s0))
    return hidden / tot if tot > 0 else 0.0


def _vectors_from_postings(index: IVFIndex) -> np.ndarray:
    """Reconstruct the (N, D) f32 corpus from the posting payload: every
    live slot carries its vector, so a scatter by global id is exact."""
    pids = index.posting_ids.cpu().numpy()
    payload = index.postings.cpu().numpy().astype(np.float32, copy=False)
    dim = payload.shape[-1]
    flat_ids = pids.reshape(-1)
    live = flat_ids >= 0
    n = int(flat_ids[live].max()) + 1 if live.any() else 0
    out = np.zeros((n, dim), np.float32)
    out[flat_ids[live]] = payload.reshape(-1, dim)[live]
    return out


def make_quantized_pipeline(index: IVFIndex, llsp_params, cfg: SearchConfig,
                            *, epoch: int = 0, arena=None, flash_path=None,
                            name: str = "helmsman", vectors=None,
                            rerank: Optional[RerankConfig] = None,
                            with_flash: bool = True,
                            fresh_source=None,
                            device: DeviceLike = None,
                            **pipe_kw) -> PrefetchPipeline:
    """The quantized-default serving pipeline for one index version: q8 hot
    tier (dead slots masked out of the scale), f32 corpus demoted to the
    mmap flash tier, adaptive re-rank on.  ``vectors`` (N, D) is the
    id-addressed corpus (reconstructed from the postings when omitted);
    ``with_flash=False`` serves raw q8 distances (the no-rerank arm);
    ``fresh_source`` attaches the freshness merge (:class:`PrefetchPipeline`)."""
    from repro_torch.core.quantize import quantize_postings

    dev = resolve_device(device)
    index = index.to(dev)
    qp = quantize_postings(index.postings, index.centroids,
                           index.posting_ids)
    tier = QuantizedTieredPostings(
        qp.q8.cpu().numpy(), qp.scale.cpu().numpy(), qp.norm2.cpu().numpy(),
        index.centroids.cpu().numpy(), index.posting_ids.cpu().numpy(),
        epoch=epoch, device=dev)
    flash = None
    if with_flash:
        if vectors is None:
            vectors = _vectors_from_postings(index)
        flash = FlashTier(vectors, flash_path, arena=arena, name=name,
                          epoch=epoch)
    cfg = dataclasses.replace(cfg, tier="q8")
    return PrefetchPipeline(index, llsp_params, cfg, tier, flash=flash,
                            rerank=rerank, fresh_source=fresh_source,
                            device=dev, **pipe_kw)


def latency_percentiles(lat_s: list[float]) -> dict:
    """p50 / p99 / mean in milliseconds of a list of latencies in seconds."""
    if not lat_s:
        return {"p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
    a = np.asarray(lat_s) * 1e3
    return {
        "p50_ms": float(np.percentile(a, 50)),
        "p99_ms": float(np.percentile(a, 99)),
        "mean_ms": float(a.mean()),
    }
