"""scan_dev_ms.bulk: mean milliseconds a batch of device time from the
scan's launch to its merge's end, by CUDA events on the scan stream
(StageTimes scan_device_ms: the ``scan.device`` span).  Beside it, for the
log: the sum over the batches; B2's device time in the profiler's trace,
which it should match, and how much of that lies inside the batches'
``scan.device`` spans as the program placed them on the host clock; and
the device's idle time by the batches' spans (``spans.keep_idle_split``).
"""

import bisect

from anns_bench import spans, stats

B2 = ("f32_topk_kernel", "f32_topk_merge_kernel")


def _inside(intervals, cover) -> float:
    """Seconds of ``intervals`` that lie inside the union of ``cover``."""
    merged = stats.merge_intervals(cover)
    starts = [a for a, _ in merged]
    tot = 0.0
    for a, b in intervals:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            tot += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
    return tot


def read(run):
    spans.keep_idle_split(run)
    ts = [t for t in spans.batch_stamps(run, "scan_device_ms")
          if t.scan_device_ms > 0.0]
    if not ts:
        return None
    ms = [t.scan_device_ms for t in ts]
    if run.trace is not None:
        b2 = [(a, b) for a, b, n in run.trace.intervals
              if any(k in n for k in B2)]
        placed = [(t.scan_device_start,
                   t.scan_device_start + 1e-3 * t.scan_device_ms)
                  for t in ts if getattr(t, "scan_device_start", 0.0) > 0.0]
        run.info["scan_dev_ms"] = {
            "batches": len(ms), "sum_s": 1e-3 * sum(ms),
            "b2_device_s": sum(b - a for a, b in b2),
            "b2_inside_s": _inside(b2, placed) if placed else None}
    return sum(ms) / len(ms)
