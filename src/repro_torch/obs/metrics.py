"""Bounded-memory streaming metrics: counters, gauges, log-bucketed
histograms.

The repo's latency accounting used to be grow-forever python lists fed to
``np.percentile`` at shutdown — fine for a bench, fatal for a daemon (the
paper's deployment serves for days).  These primitives hold O(1) memory
regardless of stream length:

* :class:`Counter` / :class:`Gauge` — label-aware scalars (labels are the
  shed/degrade/partial *reasons* and per-shard identities the fabric
  reports through);
* :class:`Histogram` — log-bucketed streaming histogram.  Bucket edges grow
  geometrically by ``growth`` (default 1.03, i.e. <= ~1.5% quantization
  error — the sqrt of one bucket's ratio — against the <= 2% accuracy gate
  the bench asserts vs ``np.percentile``).  Quantiles interpolate
  GEOMETRICALLY inside the selected bucket and clamp to the observed
  min/max, so single-sample and short streams are exact.  Histograms with
  identical bucketing **merge** by adding count arrays — per-shard or
  per-trial histograms aggregate without raw samples.

Thread contract: every mutation takes the metric's own lock (~100 ns —
invisible next to a batch scan); reads snapshot under the same lock.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import numpy as np

_TOTAL = ""          # label key of the unlabeled total


class Counter:
    """Monotonic counter with optional per-label breakdown.  ``inc(n,
    label)`` bumps both the total and the label's cell, so dashboards read
    one total and drill into reasons."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._cells: dict[str, float] = {_TOTAL: 0.0}

    def inc(self, n: float = 1.0, label: Optional[str] = None) -> None:
        with self._lock:
            self._cells[_TOTAL] += n
            if label is not None:
                self._cells[label] = self._cells.get(label, 0.0) + n

    def value(self, label: Optional[str] = None) -> float:
        with self._lock:
            return self._cells.get(_TOTAL if label is None else label, 0.0)

    def labels(self) -> dict[str, float]:
        with self._lock:
            return {k: v for k, v in self._cells.items() if k != _TOTAL}


class Gauge:
    """Last-write-wins scalar with optional per-label cells (queue depths,
    outstanding tasks per shard)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._cells: dict[str, float] = {}

    def set(self, v: float, label: Optional[str] = None) -> None:
        with self._lock:
            self._cells[_TOTAL if label is None else label] = float(v)

    def value(self, label: Optional[str] = None) -> float:
        with self._lock:
            return self._cells.get(_TOTAL if label is None else label, 0.0)

    def labels(self) -> dict[str, float]:
        with self._lock:
            return {k: v for k, v in self._cells.items() if k != _TOTAL}


class Histogram:
    """Log-bucketed streaming histogram over (lo, hi) with under/overflow
    buckets (see module doc for the accuracy contract)."""

    def __init__(self, name: str, lo: float = 1e-6, hi: float = 1e4,
                 growth: float = 1.03):
        assert lo > 0 and hi > lo and growth > 1.0
        self.name = name
        self.lo, self.hi, self.growth = float(lo), float(hi), float(growth)
        self._lg = math.log(growth)
        self.n_buckets = int(math.ceil(math.log(hi / lo) / self._lg))
        # counts[0] = underflow (< lo), counts[-1] = overflow (>= hi)
        self.counts = np.zeros(self.n_buckets + 2, np.int64)
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self.n_buckets + 1
        return 1 + min(int(math.log(v / self.lo) / self._lg),
                       self.n_buckets - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[self._bucket(v)] += 1
            self.n += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def observe_many(self, vs) -> None:
        """Vectorized :meth:`observe`: one bucket pass + one lock for the
        whole array (the per-batch quality streams fold 32 proxies per call
        — per-value locking would dominate the poller's budget)."""
        a = np.asarray(vs, np.float64).ravel()
        if a.size == 0:
            return
        idx = np.empty(a.shape, np.int64)
        under = a < self.lo
        over = a >= self.hi
        mid = ~(under | over)
        idx[under] = 0
        idx[over] = self.n_buckets + 1
        if mid.any():
            idx[mid] = 1 + np.minimum(
                (np.log(a[mid] / self.lo) / self._lg).astype(np.int64),
                self.n_buckets - 1)
        with self._lock:
            np.add.at(self.counts, idx, 1)
            self.n += a.size
            self.sum += float(a.sum())
            self.min = min(self.min, float(a.min()))
            self.max = max(self.max, float(a.max()))

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram with IDENTICAL bucketing into this one."""
        assert (self.lo, self.hi, self.growth) == \
            (other.lo, other.hi, other.growth), "bucketing mismatch"
        with other._lock:
            oc, on, osum = other.counts.copy(), other.n, other.sum
            omin, omax = other.min, other.max
        with self._lock:
            self.counts += oc
            self.n += on
            self.sum += osum
            self.min = min(self.min, omin)
            self.max = max(self.max, omax)

    def quantile(self, q: float) -> float:
        """Value at quantile q in [0, 1]: locate the bucket by cumulative
        count, interpolate geometrically by rank fraction inside it, clamp
        to the observed [min, max]."""
        with self._lock:
            if self.n == 0:
                return 0.0
            rank = q * (self.n - 1)
            cum = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if rank < cum + c:
                    frac = (rank - cum + 0.5) / c
                    if i == 0:
                        return self.min
                    if i == self.n_buckets + 1:
                        return self.max
                    v = self.lo * self.growth ** (i - 1 + frac)
                    return min(max(v, self.min), self.max)
                cum += c
            return self.max

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.n if self.n else 0.0

    def summary_ms(self) -> dict:
        """p50/p99/mean in milliseconds — drop-in for the dict
        ``latency_percentiles`` returns from raw lists."""
        return {"p50_ms": self.quantile(0.50) * 1e3,
                "p99_ms": self.quantile(0.99) * 1e3,
                "mean_ms": self.mean * 1e3}

    def to_dict(self) -> dict:
        with self._lock:
            n, s, mn, mx = self.n, self.sum, self.min, self.max
        return {"n": n, "sum": s,
                "min": mn if n else 0.0, "max": mx if n else 0.0,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99),
                "mean": s / n if n else 0.0}


class MetricsRegistry:
    """Get-or-create registry keyed by metric name; one per Observability
    bundle (no process-global state — parallel tests and A/B trials each
    read their own registry)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def counter(self, name: str) -> Counter:
        m = self._get(name, lambda: Counter(name))
        assert isinstance(m, Counter), f"{name} is {type(m).__name__}"
        return m

    def gauge(self, name: str) -> Gauge:
        m = self._get(name, lambda: Gauge(name))
        assert isinstance(m, Gauge), f"{name} is {type(m).__name__}"
        return m

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 1e4,
                  growth: float = 1.03) -> Histogram:
        m = self._get(name, lambda: Histogram(name, lo, hi, growth))
        assert isinstance(m, Histogram), f"{name} is {type(m).__name__}"
        return m

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._metrics.items())
        out: dict = {}
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = {"total": m.value(), **m.labels()}
            elif isinstance(m, Gauge):
                lab = m.labels()
                out[name] = {"value": m.value(), **lab}
            else:
                out[name] = m.to_dict()
        return out

    def render(self) -> list[str]:
        """One human-readable line per metric (the --metrics-every print)."""
        lines = []
        for name, v in self.snapshot().items():
            if "p99" in v:                             # histogram
                lines.append(
                    f"{name}: n={v['n']} mean={v['mean']:.4g} "
                    f"p50={v['p50']:.4g} p99={v['p99']:.4g}")
            else:
                head = v.pop("total", v.pop("value", 0.0))
                lab = " ".join(f"{k}={val:g}" for k, val in v.items())
                lines.append(f"{name}: {head:g}" + (f" ({lab})" if lab
                                                    else ""))
        return lines
