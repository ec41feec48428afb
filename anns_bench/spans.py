"""The program's own sub-stage readings: the stamps a served batch's
``StageTimes`` and a build's report carry, read by the per-layer readers
in ``metrics/``; the trace spans the program makes from them
(:func:`program_spans`); and :func:`idle_by_span`, the device's idle time
split by those spans.

A program without a stamp (an older checkout) leaves it out of its
records: the readers then find nothing and return None.  The stamps are
taken in every run, so no reading depends on a trace recorder that could
drop events.
"""
from __future__ import annotations

import collections

from . import stats

OUTSIDE = "outside every program span"


def batch_stamps(run, *names: str) -> list:
    """The window's batches' ``StageTimes`` that carry every stamp in
    ``names``."""
    return [t for t, _ in run.batches
            if all(hasattr(t, n) for n in names)]


def mean_ms(run, start: str, end: str):
    """Mean milliseconds a batch from stamp ``start`` to stamp ``end``,
    over the batches that took both."""
    ts = [t for t in batch_stamps(run, start, end)
          if getattr(t, end) > getattr(t, start) > 0.0]
    if not ts:
        return None
    return 1e3 * sum(getattr(t, end) - getattr(t, start)
                     for t in ts) / len(ts)


def _waiting(name: str) -> bool:
    """A span of the host waiting (``*.wait``, ``*.read_wait``) or of the
    device at work (``*.device``), not of host work."""
    return name.endswith("wait") or name.endswith(".device")


def _nesting(spans: list) -> tuple[list, list]:
    """Each span's nesting depth on its track (0 = outermost), and whether
    a span of its track nests in it."""
    by_track = collections.defaultdict(list)
    for i, (_, a, b, track) in enumerate(spans):
        by_track[track].append((a, -b, i))
    depth = [0] * len(spans)
    parent = [False] * len(spans)
    for items in by_track.values():
        stack: list = []
        for a, nb, i in sorted(items):
            while stack and stack[-1][0] <= a:
                stack.pop()
            depth[i] = len(stack)
            if stack:
                parent[stack[-1][1]] = True
            stack.append((-nb, i))
    return depth, parent


def idle_by_span(intervals, events: list, window: tuple,
                 n: int = 12) -> list:
    """Idle seconds of ``window`` by the program span the host was in:
    ``intervals`` are the device's busy (start, end, ...) intervals,
    ``events`` the trace recorder's snapshot (its "X" spans count).  Each
    piece of a gap goes to the span covering it that is, in order: not a
    span of waiting (:func:`_waiting`), a leaf (no span of its track nests
    in it: a parent's own time is mostly waiting for its children, which
    may run on other threads' tracks), the deepest; equal spans share it.
    Time no span covers is :data:`OUTSIDE`.  Returns the ``n`` largest
    [label, seconds]."""
    spans = [(e[1], e[3], e[4], e[5]) for e in events
             if e[0] == "X" and e[4] > window[0] and e[3] < window[1]]
    depth, parent = _nesting(spans)
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    tot: dict = collections.defaultdict(float)
    nxt, active = 0, []
    for g0, g1 in stats.idle_gaps(((a, b) for a, b, *_ in intervals),
                                  window):
        while nxt < len(order) and spans[order[nxt]][1] < g1:
            active.append(order[nxt])
            nxt += 1
        active = [i for i in active if spans[i][2] > g0]
        cuts = sorted({g0, g1} | {t for i in active
                                  for t in spans[i][1:3] if g0 < t < g1})
        for p0, p1 in zip(cuts, cuts[1:]):
            cover = [i for i in active
                     if spans[i][1] <= p0 and spans[i][2] >= p1]
            if not cover:
                tot[OUTSIDE] += p1 - p0
                continue
            key = {i: (_waiting(spans[i][0]), parent[i], -depth[i])
                   for i in cover}
            best = min(key.values())
            names = [spans[i][0] for i in cover if key[i] == best]
            for name in names:
                tot[name] += (p1 - p0) / len(names)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def program_spans(run) -> list:
    """The program's trace spans of a run, as its trace recorder holds them
    (``("X", name, 0, t0, t1, track, args)``), made by the program's own
    span functions from the stamps the harness keeps: each served batch's
    stage spans and their children on a track of its own, each build's
    span tree.  None from a program without those functions."""
    from repro_torch.build import pipeline as build
    from repro_torch.runtime import pipeline

    out = []
    children = getattr(pipeline, "stage_child_spans", None)
    if children is not None:
        for i, (t, _) in enumerate(run.batches):
            lane = f"batch-{i}"
            out += [("X", n, 0, a, b, lane, None)
                    for n, a, b in pipeline.stage_spans(t)]
            out += [("X", n, 0, a, b, lane, args)
                    for n, a, b, args in children(t)]
    build_spans = getattr(build, "build_spans", None)
    if build_spans is not None:
        for b in run.builds:
            out += [("X", n, 0, t0, t1, track, args)
                    for n, t0, t1, track, args in build_spans(b["report"],
                                                              "build")]
    return out


def keep_idle_split(run) -> None:
    """In a traced run, keep the device's idle time by program span
    (:func:`idle_by_span` over :func:`program_spans`) in
    ``run.info["idle_by_span"]``, which the run's log line prints."""
    if run.trace is None or "idle_by_span" in run.info:
        return
    events = program_spans(run)
    if events:
        run.info["idle_by_span"] = idle_by_span(run.trace.intervals, events,
                                                run.window)
