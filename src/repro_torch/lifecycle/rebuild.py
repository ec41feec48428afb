"""Delta-aware rebuild scheduler (port of ``repro.lifecycle.rebuild``): the
background half of the lifecycle runtime (paper §6.3: periodic rebuilds
fold the delta and drop tombstones, *while serving*).

* :class:`CorpusStore` — the append-only global-id row store (row index ==
  vector id).  Inserts land in the delta buffer first and are appended at
  rebuild-snapshot time, so corpus rows never move: posting ids stay valid
  across every rebuild.  Deletes never compact rows; they are masked out of
  the posting build, and a ``full`` rebuild remains the compaction point.
* :func:`delta_build` — stage 2 through ``build/stream.ShardAssignPipeline``
  in delta mode: ``plan_delta_shards`` diffs the corpus against the
  previous build's content-hash manifest, only dirty or new shards stream
  to the device and assign; untouched shards reuse their checkpoints byte
  for byte.  The manifest holds ``array_content_hash`` values, the same
  bytes the reference writes, so either package reuses the other's
  workdir.  The new :class:`~repro_torch.core.ivf.IVFIndex` lives on
  ``device`` (the CUDA card by default).
* :class:`RebuildScheduler` — watches the live freshness state (delta
  fill, tombstone share, rejected inserts, the drift advisory), runs the
  delta build, and swaps: snapshot the delta under the lane's lock, build,
  then (under the lock again) carry the ops that arrived during the build
  into the new epoch's state and swap epochs through the
  :class:`~repro_torch.lifecycle.version.VersionManager`; in-flight batches
  finish on the old epoch, none is dropped.
* :func:`q8_rebuild_hook` — the ``make_pipeline`` hook of a q8 deployment:
  the new epoch's flash tier is built from the corpus view, so the folded
  inserts (main ids at or above the old flash tier's rows) are re-ranked
  exactly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.build.stream import ShardAssignPipeline, plan_delta_shards
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.postings import delta_layout
from repro_torch.device import DeviceLike, resolve_device

from .ingest import LiveFreshState, UpdateLane
from .version import VersionManager


@dataclasses.dataclass(frozen=True)
class RebuildPolicy:
    delta_fill_frac: float = 0.5       # trigger: delta buffer this full
    tombstone_frac: float = 0.25       # trigger: this share of ids dead
    min_interval_s: float = 0.0        # rebuild rate limit
    per_task: int = 5000               # stage-2 shard rows (span quantum)
    capacity: Optional[int] = None     # next epoch's delta capacity
                                       # (None = keep current)


@dataclasses.dataclass
class RebuildReport:
    trigger: str
    mode: str                          # "delta" | "full"
    eid_old: int = -1
    eid_new: int = -1
    n_corpus: int = 0
    n_clusters: int = 0
    folded_inserts: int = 0
    folded_deletes: int = 0
    shards_total: int = 0
    shards_streamed: int = 0
    shards_reused: int = 0
    bytes_streamed: int = 0            # stage-2 slice bytes actually moved
    bytes_reused: int = 0              # slice bytes checkpoint reuse avoided
    full_stream_bytes: int = 0         # what a full restream would move
    t_start: float = 0.0               # the rebuild began (before snapshot)
    t_snapshot: float = 0.0
    t_built: float = 0.0
    t_swapped: float = 0.0
    carried_ops: int = 0               # delta rows applied during the build
    tier: str = "f32"                  # first-pass payload the new epoch's
                                       # pipeline serves ("q8" = quantized
                                       # shards + flash re-rank tier): the
                                       # rebuild must keep the serving tier
    stage2: Optional[dict] = None      # delta_build's stats (shard stamps
                                       # included) of the build that swapped

    @property
    def io_cut_x(self) -> float:
        return self.full_stream_bytes / max(self.bytes_streamed, 1)


class CorpusStore:
    """Append-only host corpus with stable global row ids.

    Growth is amortized (capacity doubling); ``view()`` is a zero-copy
    window of the live rows, safe to hand to the shard pipeline."""

    def __init__(self, x0: np.ndarray):
        x0 = np.ascontiguousarray(x0, dtype=np.float32)
        self._n = x0.shape[0]
        self._buf = x0
        self.dim = x0.shape[1]

    @property
    def n(self) -> int:
        return self._n

    def view(self) -> np.ndarray:
        return self._buf[: self._n]

    def append(self, vecs: np.ndarray) -> tuple[int, int]:
        vecs = np.asarray(vecs, np.float32).reshape(-1, self.dim)
        lo = self._n
        hi = lo + vecs.shape[0]
        if hi > self._buf.shape[0]:
            cap = max(hi, 2 * self._buf.shape[0])
            grown = np.empty((cap, self.dim), np.float32)
            grown[: self._n] = self._buf[: self._n]
            self._buf = grown
        self._buf[lo:hi] = vecs
        self._n = hi
        return lo, hi


def _in_child(fn, *args):
    """``fn(*args)`` in a fresh process started by ``spawn`` (``fn`` and its
    module must import without torch's state: ``core/postings.py``)."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        return pool.apply(fn, args)


def _chunks(n: int, per_task: int) -> list[tuple[int, int]]:
    return [(s, min(s + per_task, n)) for s in range(0, n, per_task)]


def _manifest_path(workdir: str) -> str:
    return os.path.join(workdir, "shard_manifest.json")


def load_manifest(workdir: str) -> Optional[dict]:
    p = _manifest_path(workdir)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def save_manifest(workdir: str, manifest: dict) -> None:
    p = _manifest_path(workdir)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, p)


def delta_build(
    x: np.ndarray,
    centroids: np.ndarray,
    workdir: str,
    *,
    cluster_len: int,
    eps: float,
    max_replicas: int,
    per_task: int = 5000,
    tombstone: Optional[np.ndarray] = None,
    use_manifest: bool = True,
    device: DeviceLike = None,
) -> tuple[IVFIndex, dict]:
    """Stage 2 + posting build with content-hash shard reuse.

    Returns (index on ``device``, stats).  ``use_manifest=False`` forces a
    full restream (the A/B baseline for the I/O-cut counters).  Tombstoned
    rows are masked out of the posting build (the fold that drops deletes),
    but the corpus keeps its rows so shard hashes stay stable.  The stats
    add ``postings_s``, the seconds from the checkpoint reads to the
    postings on ``device``, ``assign_load_s`` and ``layout_s``, those of
    the reads and of the layout (``core/postings.py``, in a child process
    started by ``spawn``), to the reference's keys.
    """
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    shards_dir = os.path.join(workdir, "shards")
    os.makedirs(shards_dir, exist_ok=True)
    n = x.shape[0]
    spans = _chunks(n, per_task)
    paths = [os.path.join(shards_dir, f"assign_{i:05d}.npz")
             for i in range(len(spans))]
    prev = load_manifest(workdir) if use_manifest else None
    plan = plan_delta_shards(x, spans, paths, centroids, prev)
    pipe = ShardAssignPipeline(
        x, centroids, [spans[i] for i in plan.dirty],
        [paths[i] for i in plan.dirty],
        eps=eps, max_replicas=max_replicas, device=dev)
    try:
        stamps = pipe.run()
    finally:
        pipe.close()
    t0 = time.perf_counter()
    # the checkpoint reads and the layout run in a child process: in a
    # serving process they would hold the interpreter lock for seconds
    # while the engine's poller waits on it
    out = _in_child(delta_layout, paths, max_replicas, tombstone, n,
                    centroids.shape[0], cluster_len)
    src = torch.from_numpy(out["src"]).to(dev)
    rows = np.ascontiguousarray(x[:n])
    xt = torch.from_numpy(rows if rows.flags.writeable else rows.copy())
    xt = xt.to(dev)
    postings = xt[src.clamp_min(0)]
    postings[src < 0] = 0.0
    del xt
    postings_s = time.perf_counter() - t0
    index = IVFIndex(
        torch.from_numpy(np.array(centroids, np.float32)).to(dev),
        postings, torch.from_numpy(out["ids"]).to(dev))
    save_manifest(workdir, plan.manifest)
    stats = {
        "shards_total": len(spans),
        "shards_streamed": len(plan.dirty),
        "shards_reused": len(plan.reused),
        "bytes_streamed": int(pipe.bytes_streamed),
        "bytes_reused": int(plan.bytes_reused),
        "full_stream_bytes": int(x[:n].nbytes),
        "folded_deletes": out["folded_deletes"],
        "postings_s": postings_s,
        "assign_load_s": out["assign_load_s"],
        "layout_s": out["layout_s"],
        "shard_stamps": [t.asdict() for t in stamps],
    }
    return index, stats


class RebuildScheduler:
    """Threshold-triggered live rebuild + atomic epoch swap.

    ``make_pipeline(index, fresh_state)`` builds (and warms) the serving
    pipeline for a freshly built index: the deployment-specific part (tier
    construction, SearchConfig, warmup shapes) stays with the caller (for a
    q8 deployment, :func:`q8_rebuild_hook`).  The scheduler owns *when* to
    rebuild, the snapshot/carry protocol, and the swap ordering.  Builds and
    the next epoch's freshness state go to the live state's device, the one
    the deployment already serves from.
    """

    # retained report/failure windows: the scheduler is a long-lived
    # daemon; the full record lands on the lifecycle trace track, these are
    # the recent window
    MAX_REPORTS = 64
    MAX_FAILURES = 64

    def __init__(
        self,
        *,
        name: str,
        corpus: CorpusStore,
        centroids: np.ndarray,
        workdir: str,
        lane: UpdateLane,
        versions: "VersionManager",
        make_pipeline: Callable,
        cluster_len: int,
        closure_eps: float = 0.2,
        max_replicas: int = 4,
        policy: RebuildPolicy = RebuildPolicy(),
        clock=time.monotonic,
        drift=None,
        obs=None,
    ):
        self.name = name
        self.corpus = corpus
        self.centroids = np.asarray(centroids, np.float32)
        self.workdir = workdir
        self.lane = lane
        self.versions = versions
        self.make_pipeline = make_pipeline
        self.cluster_len = int(cluster_len)
        self.closure_eps = float(closure_eps)
        self.max_replicas = int(max_replicas)
        self.policy = policy
        self.clock = clock
        self.drift = drift                 # DriftMonitor advisory source
        self.obs = obs                     # lifecycle trace track target
        # lint: bounded-by(trimmed to MAX_REPORTS after each append)
        self.reports: list[RebuildReport] = []
        # lint: bounded-by(trimmed to MAX_FAILURES after each append)
        self.failures: list[str] = []
        self.rebuilding = threading.Event()
        self.swapped = threading.Event()   # set after each completed swap
        self._last_rebuild = -1e30
        self._seen_rejected = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- trigger -----------------------------------------------------------
    def due(self, now: Optional[float] = None) -> Optional[str]:
        """Rebuild trigger reason, or None."""
        now = self.clock() if now is None else now
        if self.rebuilding.is_set():
            return None
        if now - self._last_rebuild < self.policy.min_interval_s:
            return None
        st = self.lane.state
        if st.fill_frac >= self.policy.delta_fill_frac:
            return "delta_fill"
        if st.tombstone_frac >= self.policy.tombstone_frac:
            return "tombstones"
        if self.lane.stats.rejected_full > self._seen_rejected:
            return "insert_rejected"
        if self.drift is not None:
            # quality trigger: the insert stream drifted away from the
            # epoch's centroids; rebuild before the capacity thresholds
            # would have noticed anything
            reason = self.drift.advisory()
            if reason is not None:
                return reason
        return None

    # -- the rebuild + swap flow ------------------------------------------
    def rebuild_and_swap(self, trigger: str = "manual",
                         mode: str = "delta") -> RebuildReport:
        """Fold the delta, rebuild stage 2 (delta mode), swap epochs.

        Runs on the caller's thread (the background poller uses
        ``start``).  The engine keeps serving throughout: only the two
        snapshot/carry critical sections take the lane's state lock, and
        the swap itself is the VersionManager's atomic publish."""
        rep = RebuildReport(trigger=trigger, mode=mode)
        self.rebuilding.set()
        try:
            return self._rebuild(rep)
        finally:
            self.rebuilding.clear()
            self._last_rebuild = self.clock()
            self._seen_rejected = self.lane.stats.rejected_full

    def _rebuild(self, rep: RebuildReport) -> RebuildReport:
        t_start = rep.t_start = self.clock()
        st = self.lane.state
        dev = st.device
        # -- snapshot: fold the delta prefix into the corpus ---------------
        with st.lock:
            f0 = st.fill
            vecs0, ids0 = st.delta_rows(0, f0)
            tomb0 = st.tombstone_bits()
            rep.t_snapshot = self.clock()
        if f0:
            # global-id invariant: delta ids were minted sequentially from
            # corpus.n, so folding the prefix in order lands each vector at
            # the row its id already names.  Idempotent against a prior
            # FAILED attempt that already appended part (or all) of this
            # prefix: fold only the rows the corpus does not have yet.
            already = self.corpus.n - int(ids0[0])
            if not 0 <= already <= f0:
                raise RuntimeError(
                    f"delta ids out of step with corpus rows "
                    f"(corpus n={self.corpus.n}, delta ids "
                    f"[{ids0[0]}, {ids0[-1]}])")
            if already < f0:
                self.corpus.append(vecs0[already:])
            assert self.corpus.n == int(ids0[-1]) + 1
        rep.folded_inserts = int(f0)
        x = self.corpus.view()
        # the build's and the new epoch's device work go on a stream of
        # their own: on the default stream the engine's plan stage would
        # queue behind the corpus's copy to the card and the new tier's
        # copies back
        side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        ctx = torch.cuda.stream(side) if side is not None \
            else contextlib.nullcontext()
        with ctx:
            index, bstats, new_state, pipeline = self._build(
                rep, x, tomb0, st, dev)
        if side is not None:
            side.synchronize()
        # delta rebuilds must emit the same serving tier they replace: a
        # make_pipeline hook that silently fell back to f32 would undo the
        # quantized default at the first rebuild
        rep.tier = getattr(pipeline, "tier_kind", "f32")

        # -- atomic swap: carry the ops applied during the build -----------
        with st.lock:
            f1 = st.fill
            carry_v, carry_i = st.delta_rows(f0, f1)
            new_state.adopt(carry_v, carry_i, st.tombstone_bits())
            # next_id continuity: ids minted during the build stay minted
            new_state.next_id = st.next_id
            # seq continuity must be re-synced HERE, not at construction:
            # the old state kept publishing during the (slow) build, and a
            # new epoch re-issuing already-used seqs would corrupt the
            # visibility stamps (ops marked visible by batches whose
            # snapshot never contained them)
            new_state.seq = st.seq
            new_state.publish()
            self.lane.retarget(new_state)
            old_ep, new_ep = self.versions.swap(self.name, pipeline,
                                               fresh=new_state)
        rep.carried_ops = int(f1 - f0)
        rep.eid_old, rep.eid_new = old_ep.eid, new_ep.eid
        rep.t_swapped = self.clock()
        self._emit_rebuild_trace(rep, bstats, t_start)
        if self.drift is not None:
            # the advisory's evidence was just folded into the new epoch
            self.drift.reset()
        self.reports.append(rep)
        del self.reports[: -self.MAX_REPORTS]
        self.swapped.set()
        return rep

    def _build(self, rep: RebuildReport, x: np.ndarray, tomb0, st, dev):
        """The delta build, then the next epoch's freshness state and
        pipeline: (index, build stats, state, pipeline)."""
        index, bstats = delta_build(
            x, self.centroids, self.workdir,
            cluster_len=self.cluster_len, eps=self.closure_eps,
            max_replicas=self.max_replicas, per_task=self.policy.per_task,
            tombstone=tomb0, use_manifest=(rep.mode == "delta"), device=dev)
        rep.n_corpus = int(x.shape[0])
        rep.n_clusters = int(index.n_clusters)
        rep.folded_deletes = bstats["folded_deletes"]
        for key in ("shards_total", "shards_streamed", "shards_reused",
                    "bytes_streamed", "bytes_reused", "full_stream_bytes"):
            setattr(rep, key, bstats[key])
        rep.stage2 = bstats
        rep.t_built = self.clock()

        # -- next epoch's freshness state ----------------------------------
        capacity = self.policy.capacity or st.capacity
        new_state = LiveFreshState(
            dim=self.corpus.dim, capacity=capacity, n_main=self.corpus.n,
            next_id=None, seq0=st.seq, device=dev)  # seq stays monotonic
        return index, bstats, new_state, self.make_pipeline(index, new_state)

    def _emit_rebuild_trace(self, rep: RebuildReport, bstats: dict,
                            t_start: float) -> None:
        """Rebuild/swap on its own ``lifecycle`` trace track: sequential
        snapshot / build / swap "X" spans, per-shard stage-2 stream
        lifetimes as async pairs (double-buffered shards overlap, so they
        must not be "X" spans), and the epoch-swap instant tagged with the
        serving tier the new epoch inherits."""
        if self.obs is None or not self.obs.tracing:
            return
        tr = self.obs.trace
        tr.span("snapshot", t_start, rep.t_snapshot, track="lifecycle",
                args={"trigger": rep.trigger,
                      "folded_inserts": rep.folded_inserts})
        tr.span("build", rep.t_snapshot, rep.t_built, track="lifecycle",
                args={"mode": rep.mode,
                      "shards_streamed": rep.shards_streamed,
                      "shards_reused": rep.shards_reused,
                      "io_cut_x": round(rep.io_cut_x, 2)})
        for stamp in bstats.get("shard_stamps", ()):
            if stamp.get("resumed"):
                continue            # checkpoint hit: nothing streamed
            aid = f"rebuild{rep.eid_new}-shard{stamp['shard']}"
            tr.abegin("shard_stream", aid, t=stamp["load_start"],
                      track="lifecycle-shards",
                      args={"shard": stamp["shard"],
                            "rows": stamp["rows"],
                            "bytes": stamp["bytes"]})
            tr.aend("shard_stream", aid, t=stamp["assign_done"],
                    track="lifecycle-shards")
        tr.span("swap", rep.t_built, rep.t_swapped, track="lifecycle",
                args={"carried_ops": rep.carried_ops})
        tr.instant("epoch_swap", t=rep.t_swapped, track="lifecycle",
                   args={"eid_old": rep.eid_old, "eid_new": rep.eid_new,
                         "tier": rep.tier})

    # -- background poller -------------------------------------------------
    def start(self, poll_s: float = 0.05) -> None:
        assert self._thread is None, "scheduler already started"
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                reason = self.due()
                if reason is not None:
                    try:
                        self.rebuild_and_swap(trigger=reason)
                    except Exception as e:   # noqa: BLE001 (daemon must
                        # survive a failed attempt: the fold is idempotent,
                        # partial appends are detected and skipped on
                        # retry, and a retry re-snapshots a LARGER prefix,
                        # so e.g. a capacity overrun self-heals; dying here
                        # would silently stop all future rebuilds while the
                        # delta fills and inserts start bouncing)
                        self.failures.append(repr(e))
                        del self.failures[: -self.MAX_FAILURES]
                        print(f"[rebuild-sched] attempt failed, will retry: "
                              f"{e!r}")
                self._stop.wait(poll_s)

        self._thread = threading.Thread(target=loop, name="rebuild-sched",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None


def q8_rebuild_hook(corpus: CorpusStore, llsp_params, cfg, *,
                    flash_dir: str, name: str = "helmsman", arena=None,
                    rerank=None, warm_sizes=(16, 32),
                    device: DeviceLike = None, **pipe_kw) -> Callable:
    """``make_pipeline(index, state)`` for a q8 deployment with the flash
    re-rank: ``make_quantized_pipeline`` over the rebuilt index with the
    new epoch's flash tier built from ``corpus.view()`` (one file per
    epoch under ``flash_dir``), the state's snapshots as its fresh source,
    warmed at ``warm_sizes``.  Built from the postings instead, the flash
    tier would miss every row no posting holds, and the pipeline keeps any
    id at or above ``flash.n`` at its incoming distance: the folded inserts
    would then skip the exact re-rank.  ``make.warmed`` lists each epoch's
    warm batches (one scan dispatch each)."""
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    built = [0]

    def make(index: IVFIndex, state: LiveFreshState):
        built[0] += 1
        vectors = corpus.view()
        pipe = make_quantized_pipeline(
            index, llsp_params, cfg, epoch=built[0], arena=arena,
            flash_path=os.path.join(flash_dir,
                                    f"{name}.e{built[0]}.flash.f32"),
            name=f"{name}.e{built[0]}", vectors=vectors, rerank=rerank,
            fresh_source=state.snapshot, device=device, **pipe_kw)
        make.warmed.append(pipe.warmup(batch_sizes=warm_sizes))
        return pipe

    make.warmed = []
    return make
