"""Unified telemetry layer (port of ``repro.obs``): per-query distributed
traces + streaming metrics, threaded through engine, batcher, pipeline and
lifecycle.

One :class:`Observability` bundle per serving stack:

* ``obs.trace`` — :class:`~repro_torch.obs.trace.TraceRecorder`:
  ring-bounded per-thread span/instant buffers carrying a ``trace_id`` minted at request
  admission, exportable as Chrome/Perfetto ``trace_event`` JSON
  (``obs.trace.export(path)`` -> open in https://ui.perfetto.dev);
* ``obs.metrics`` — :class:`~repro_torch.obs.metrics.MetricsRegistry`:
  counters / gauges / log-bucketed streaming histograms (bounded memory, mergeable,
  p50/p99 within ~2% of ``np.percentile``).

Components take ``obs=None`` and default to a PRIVATE disabled bundle
(``Observability.off()``) — no module-global registry, so parallel tests
and paired A/B trials never share state.  A disabled bundle keeps metrics
live (they are O(1) and replace the old grow-forever lists) but turns the
trace recorder into one-integer-compare no-ops; the tracing-overhead gate
in the reference's serving benchmark measures exactly this
off-vs-``sample_rate=1.0`` pair.
"""
from __future__ import annotations

import time

from .harvest import HarvestRing, load_npz
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .quality import QualityMonitor, recall_proxy, shadow_sampled
from .slo import (BurnRule, SLOTracker, default_rules, health_snapshot,
                  write_health)
from .trace import TraceRecorder, check_well_nested

__all__ = [
    "BurnRule", "Counter", "Gauge", "HarvestRing", "Histogram",
    "MetricsRegistry", "Observability", "QualityMonitor", "SLOTracker",
    "TraceRecorder", "check_well_nested", "default_rules",
    "health_snapshot", "load_npz", "recall_proxy", "shadow_sampled",
    "write_health",
]


class Observability:
    """Trace recorder + metrics registry, shared by one serving stack."""

    def __init__(self, sample_rate: float = 1.0, *, enabled: bool = True,
                 max_events_per_thread: int = 1 << 15,
                 clock=time.perf_counter):
        self.trace = TraceRecorder(
            sample_rate, enabled=enabled,
            max_events_per_thread=max_events_per_thread, clock=clock)
        self.metrics = MetricsRegistry()

    @classmethod
    def off(cls) -> "Observability":
        """Metrics-only bundle: tracing disabled (mint() == 0 for every
        request), metrics live.  The default for every component."""
        return cls(enabled=False)

    @property
    def tracing(self) -> bool:
        return self.trace.enabled

    def mint(self) -> int:
        return self.trace.mint()
