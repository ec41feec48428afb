"""Readings shared by the metric readers in ``metrics/``: each reader names
one metric of one kind of cell and calls one of these on the run."""
from __future__ import annotations

import numpy as np


def qps(run):
    """Queries answered (status "ok") within the measured window, over the
    time from the window's start to the last of those answers.  Answers
    come a batch at a time, so ending the count at the last answer rather
    than at the close keeps a batch that lands just after the close from
    deciding the reading.  Every request counts, none is sampled."""
    if run.done is None:
        return None
    m = run.ok & (run.done <= run.window[1])
    if not m.any():
        return None
    return int(m.sum()) / (float(run.done[m].max()) - run.window[0])


def batch_queries(run):
    """Requests completed over batches served in the window, from the
    engine's own counters (EngineStats)."""
    st = run.engine
    if st is None or not st.batches:
        return None
    return st.completed / st.batches


def plan_ms(run):
    """Mean milliseconds of the pipeline's plan stage a batch (StageTimes
    plan_end - plan_start): the centroid scan and LLSP in FIFO batching."""
    if not run.batches:
        return None
    return 1e3 * sum(t.plan_end - t.plan_start
                     for t, _ in run.batches) / len(run.batches)


def nprobe_mean(run):
    """Mean probes a query over the window's batches (the BatchResult
    nprobe that LLSP chose)."""
    if not run.batches:
        return None
    return float(np.concatenate([n for _, n in run.batches]).mean())


def device_idle(run):
    """Percent of the measured window in which no kernel or copy ran on
    the card, from the profiler's device intervals."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
