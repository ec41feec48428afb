"""Per-query distributed tracing with Chrome/Perfetto ``trace_event`` export.

The serving path is five subsystems deep (batcher -> engine -> pipeline ->
fabric -> shards) and until now each kept its own private wall-clock stamps
with no shared request identity — nobody could answer "where did this p99
query spend its 71 ms?".  :class:`TraceRecorder` fixes that with one
design constraint: the hot path must stay cheap enough to leave tracing ON
at ``sample_rate=1.0`` (the bench gates <= 5% q/s overhead).

How the budget is met:

* **per-thread ring buffers** — recording is an append to a plain list
  owned by the calling thread (``threading.local``); the only lock is taken
  ONCE per thread, at buffer registration.  Export snapshots every buffer.
* **ring-bounded** — a buffer past ``max_events_per_thread`` drops its
  oldest half and counts the drop (``dropped_events``), so a serving daemon
  never grows without bound and never silently loses history either;
* **no clock reads the caller didn't already pay for** — span recording
  takes EXPLICIT start/end stamps, so stage spans are emitted from the
  ``StageTimes`` stamps the pipeline already collects per batch (zero extra
  ``perf_counter`` calls on the hot path);
* **deterministic sampling** — :meth:`mint` draws the trace decision from a
  Knuth multiplicative hash of the id itself, so a given ``sample_rate``
  selects the same requests on every replay of a seeded trace.
  ``trace_id == 0`` means "not sampled": every recording call takes the
  id and the unsampled path costs one integer compare.

Event model -> ``trace_event`` mapping (https://perfetto.dev):

=========  ============================================================
``span``    "X" complete event (ts + dur, µs) — must be WELL-NESTED per
            track; used for pipeline stages, shard scans, merges
``instant`` "i" instant event (thread scope) — terminal outcomes,
            failovers, hedges, sheds
``abegin``/ "b"/"e" async pair matched by (cat, id) — task LIFETIMES
``aend``    (dispatch -> resolve), which overlap freely on a shard track
            while tasks queue, so they must not be "X" spans
``flow_start``/ "s"/"f" flow pair matched by (cat, id) — SPAN LINKS: the
``flow_finish`` Perfetto UI renders an arrow from the start event's
            enclosing slice to the finish event's slice, so a request
            span visually fans out to the shard tasks it spawned
=========  ============================================================

Tracks are logical (``"requests"``, ``"shard-3"``, ``"batch-5"``, …) and
mapped to synthetic tids with thread_name metadata at export, so the
flamegraph reads by subsystem rather than by python thread id.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

_KNUTH = 2654435761          # Knuth's multiplicative hash constant
_MASK32 = 0xFFFFFFFF


def _sampled(trace_id: int, rate: float) -> bool:
    """Deterministic per-id sampling decision: hash the id to [0, 1)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return ((trace_id * _KNUTH) & _MASK32) / 4294967296.0 < rate


class TraceRecorder:
    """Lock-cheap, ring-bounded span/instant recorder (see module doc)."""

    def __init__(self, sample_rate: float = 1.0, *, enabled: bool = True,
                 max_events_per_thread: int = 1 << 15,
                 clock=time.perf_counter):
        self.sample_rate = float(sample_rate)
        self.enabled = bool(enabled) and self.sample_rate > 0.0
        self.max_events_per_thread = int(max_events_per_thread)
        self.clock = clock
        self._tls = threading.local()
        self._lock = threading.Lock()       # buffer registry + id mint only
        # lint: bounded-by(one entry per thread; buffers are ring-trimmed)
        self._buffers: list[tuple[str, list, list]] = []  # (thread, buf, drops)
        self._next_id = 1

    # -- identity ----------------------------------------------------------
    def mint(self) -> int:
        """Mint a trace id at request admission.  Returns 0 when the request
        falls outside ``sample_rate`` (or tracing is off) — the untraced
        sentinel every recording call short-circuits on."""
        if not self.enabled:
            return 0
        with self._lock:
            tid = self._next_id
            self._next_id += 1
        return tid if _sampled(tid, self.sample_rate) else 0

    # -- recording ---------------------------------------------------------
    def _buf(self) -> list:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = []
            drops = [0]
            self._tls.buf = buf
            self._tls.drops = drops
            with self._lock:
                self._buffers.append(
                    (threading.current_thread().name, buf, drops))
        elif len(buf) >= self.max_events_per_thread:
            # ring bound: drop the OLDEST half (recent history is what a
            # post-incident export wants) and count it — never silent
            half = self.max_events_per_thread // 2
            self._tls.drops[0] += half
            del buf[:half]
        return buf

    def span(self, name: str, t0: float, t1: float, *, trace_id: int = 0,
             track: Optional[str] = None, args: Optional[dict] = None
             ) -> None:
        """Complete ("X") event from stamps the caller ALREADY took.  Spans
        sharing a track must nest; overlapping lifetimes belong in
        :meth:`abegin`/:meth:`aend` instead."""
        if not self.enabled or t1 < t0:
            return
        self._buf().append(("X", name, trace_id, t0, t1, track, args))

    def instant(self, name: str, *, t: Optional[float] = None,
                trace_id: int = 0, track: Optional[str] = None,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        t = self.clock() if t is None else t
        self._buf().append(("i", name, trace_id, t, t, track, args))

    def abegin(self, name: str, async_id: int, *, t: Optional[float] = None,
               trace_id: int = 0, track: Optional[str] = None,
               args: Optional[dict] = None) -> None:
        """Open an async ("b") span matched to :meth:`aend` by async_id —
        the representation for task lifetimes that overlap on one track."""
        if not self.enabled:
            return
        t = self.clock() if t is None else t
        self._buf().append(("b", name, trace_id, t, async_id, track, args))

    def aend(self, name: str, async_id: int, *, t: Optional[float] = None,
             track: Optional[str] = None,
             args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        t = self.clock() if t is None else t
        self._buf().append(("e", name, 0, t, async_id, track, args))

    def flow_start(self, name: str, flow_id, *, t: Optional[float] = None,
                   trace_id: int = 0, track: Optional[str] = None,
                   args: Optional[dict] = None) -> None:
        """Open a flow arrow ("s") bound to :meth:`flow_finish` by flow_id.
        Perfetto draws start -> finish as an arrow between the slices that
        enclose the two events, which is how a request span links to the
        shard tasks it fanned out to."""
        if not self.enabled:
            return
        t = self.clock() if t is None else t
        self._buf().append(("s", name, trace_id, t, flow_id, track, args))

    def flow_finish(self, name: str, flow_id, *, t: Optional[float] = None,
                    trace_id: int = 0, track: Optional[str] = None,
                    args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        t = self.clock() if t is None else t
        self._buf().append(("f", name, trace_id, t, flow_id, track, args))

    # -- readout -----------------------------------------------------------
    def snapshot(self) -> list[tuple]:
        """All recorded events (every thread's buffer, registration order).
        Safe to call while recording continues: buffers are only appended
        to by their owner threads and list snapshots are atomic enough for
        a post-run export (the daemon exports after stop())."""
        with self._lock:
            bufs = list(self._buffers)
        out: list[tuple] = []
        for _, buf, _ in bufs:
            out.extend(list(buf))
        return out

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return sum(d[0] for _, _, d in self._buffers)

    def clear(self) -> None:
        with self._lock:
            for _, buf, drops in self._buffers:
                buf.clear()
                drops[0] = 0

    def export(self, path: Optional[str] = None) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON (open in ui.perfetto.dev or
        chrome://tracing).  Timestamps are rebased to the earliest event so
        the UI opens at t=0; tracks become synthetic tids with thread_name
        metadata."""
        events = self.snapshot()
        with self._lock:
            bufs = list(self._buffers)
        t0 = min((e[3] for e in events), default=0.0)
        tracks: dict[str, int] = {}
        te: list[dict] = []

        def tid_of(track: Optional[str], fallback: str) -> int:
            key = track if track is not None else f"thread:{fallback}"
            if key not in tracks:
                tracks[key] = len(tracks) + 1
                te.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tracks[key], "args": {"name": key}})
            return tracks[key]

        # events carry no thread tag; re-walk per buffer for the fallback
        for tname, buf, _ in bufs:
            for ev in list(buf):
                kind, name, trace_id, ta, tb, track, args = ev
                tid = tid_of(track, tname)
                a = dict(args) if args else {}
                if trace_id:
                    a.setdefault("trace_id", trace_id)
                row = {"ph": kind, "name": name, "pid": 1, "tid": tid,
                       "ts": (ta - t0) * 1e6}
                if a:
                    row["args"] = a
                if kind == "X":
                    row["dur"] = max((tb - ta) * 1e6, 0.0)
                elif kind == "i":
                    row["s"] = "t"
                elif kind in ("s", "f"):   # flow arrow matched by (cat, id)
                    row["cat"] = "flow"
                    row["id"] = tb
                    if kind == "f":
                        row["bp"] = "e"    # bind to enclosing slice
                else:                      # async b/e matched by (cat, id)
                    row["cat"] = "task"
                    row["id"] = tb
                te.append(row)
        doc = {"traceEvents": te, "displayTimeUnit": "ms",
               "otherData": {"dropped_events": self.dropped_events}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def check_well_nested(trace_events: list[dict],
                      eps_us: float = 0.01) -> list[str]:
    """Structural validation of an exported trace: "X" spans sharing a
    (pid, tid) must be properly nested (a span either contains or is
    disjoint from every other span on its track), every async "b" must
    have a matching "e", and every flow arrow must have BOTH endpoints —
    an "s" with no "f" (or vice versa) sharing its (cat, id) renders as a
    dangling arrow in the Perfetto UI and is reported here.  Returns
    human-readable violations (empty = valid).
    Used by the trace-integrity tests AND the bench drill gate — the export
    is checked, not trusted.

    ``eps_us`` absorbs float round-off: a span's end is reconstructed as
    ts + dur (two separately-rounded µs values), so back-to-back stages
    sharing a stamp can disagree by sub-nanosecond amounts — tolerated up
    to 10 ns, far below anything a real overlap produces."""
    bad: list[str] = []
    by_track: dict[tuple, list] = {}
    opens: dict[tuple, int] = {}
    flow_s: dict[tuple, int] = {}
    flow_f: dict[tuple, int] = {}
    for ev in trace_events:
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "X":
            by_track.setdefault(key, []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                 ev.get("name")))
        elif ph == "b":
            opens[(ev.get("cat"), ev.get("id"))] = \
                opens.get((ev.get("cat"), ev.get("id")), 0) + 1
        elif ph == "e":
            k = (ev.get("cat"), ev.get("id"))
            if opens.get(k, 0) <= 0:
                bad.append(f"async end without begin: {ev.get('name')} {k}")
            else:
                opens[k] -= 1
        elif ph == "s":
            k = (ev.get("cat"), ev.get("id"))
            flow_s[k] = flow_s.get(k, 0) + 1
        elif ph == "f":
            k = (ev.get("cat"), ev.get("id"))
            flow_f[k] = flow_f.get(k, 0) + 1
    for k, n in opens.items():
        if n > 0:
            bad.append(f"async begin without end: {k}")
    for k in flow_s:
        if k not in flow_f:
            bad.append(f"flow start without finish: {k}")
    for k in flow_f:
        if k not in flow_s:
            bad.append(f"flow finish without start: {k}")
    for key, spans in by_track.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list[tuple] = []
        for ts, end, name in spans:
            while stack and stack[-1][1] <= ts + eps_us:
                stack.pop()
            if stack and end > stack[-1][1] + eps_us:
                bad.append(
                    f"track {key}: span {name!r} [{ts:.1f},{end:.1f}] "
                    f"crosses {stack[-1][2]!r} "
                    f"[{stack[-1][0]:.1f},{stack[-1][1]:.1f}]")
            stack.append((ts, end, name))
    return bad
