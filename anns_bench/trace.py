"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to device intervals on the host's clock.

Every device activity (kernels and copies) becomes an interval in
``time.perf_counter`` seconds: a ``record_function`` anchor, stamped on the
host clock as the profiler starts, ties the profiler's time base to the
host stamps of the program's stages.  From the intervals come the device's
busy time (their union), each kernel's device time by name, and the idle
gaps, each named by the host stage that overlaps it most.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import torch

from . import stats

ANCHOR = "anns_bench.anchor"


@dataclasses.dataclass
class DeviceTrace:
    intervals: list          # (start_s, end_s, name) on the host clock
    window: tuple            # (start_s, end_s) on the host clock

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return stats.busy_time(((a, b) for a, b, _ in self.intervals),
                               self.window)

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the activities whose name contains any of
        ``names``, over the whole trace."""
        return sum(b - a for a, b, n in self.intervals
                   if any(k in n for k in names))

    def top_ops(self, n: int = 10) -> list:
        tot: dict = collections.defaultdict(float)
        for a, b, name in self.intervals:
            tot[_short(name)] += b - a
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_by_stage(self, stages: list, n: int = 10) -> list:
        """Idle seconds of the window by what the host was doing: each gap
        goes to the host stage that overlaps it most, a stage of work
        (``stages``: (start_s, end_s, label, rank), lower rank first)
        before a stage of waiting."""
        tot: dict = collections.defaultdict(float)
        srt = sorted(stages)
        nxt, active = 0, []
        for g0, g1 in stats.idle_gaps(((a, b) for a, b, _ in self.intervals),
                                      self.window):
            while nxt < len(srt) and srt[nxt][0] < g1:
                active.append(srt[nxt])
                nxt += 1
            active = [st for st in active if st[1] > g0]
            best, label = (9, 0.0), "host: outside the stage stamps"
            for a, b, lab, rank in active:
                ov = min(b, g1) - max(a, g0)
                if ov > 0.0 and (rank, -ov) < (best[0], -best[1]):
                    best, label = (rank, ov), lab
            tot[label] += g1 - g0
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    for pre in ("void ", "(anonymous namespace)::"):
        name = name.replace(pre, "")
    return name.split("(")[0][:80] or name[:80]


class Profile:
    """Context manager: profiles CPU and CUDA activity, then yields the
    device intervals through :meth:`result`."""

    def __init__(self):
        self.prof = None
        self.anchor_host = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.anchor_host = time.perf_counter()
        with record_function(ANCHOR):
            pass
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def result(self, window: tuple) -> Optional[DeviceTrace]:
        """Device intervals on the host clock; None when the profiler saw
        no device activity."""
        events = self.prof.events()
        anchor = [e for e in events if e.name == ANCHOR]
        if not anchor:
            return None
        off = self.anchor_host - anchor[0].time_range.start * 1e-6
        iv = [(e.time_range.start * 1e-6 + off,
               e.time_range.end * 1e-6 + off, e.name)
              for e in events
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)]
        if not iv:
            return None
        return DeviceTrace(iv, window)


def host_stages(run) -> list:
    """(start_s, end_s, label, rank) host intervals of a run's stages: each
    served batch's stamped stages (work ranks 0, the wait from the scan's
    dispatch to its harvest 1), each build's stages in turn."""
    out = []
    for t, _ in run.batches:
        for name, a, b, rank in (
                ("plan", t.plan_start, t.plan_end, 0),
                ("gather", t.gather_start, t.gather_end, 0),
                ("copy to device", t.gather_end, t.stream_end, 0),
                ("rerank", t.rerank_start, t.rerank_end, 0),
                ("scan dispatch to harvest", t.scan_dispatch, t.scan_done,
                 1)):
            if b > a > 0.0:
                out.append((a, b, f"host: {name}", rank))
    for b in run.builds:
        t = b["start"]
        for name, d in b["report"].stage_seconds.items():
            out.append((t, t + d, f"host: build {name}", 0))
            t += d
    return out
