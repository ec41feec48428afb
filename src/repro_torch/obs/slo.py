"""Multi-window burn-rate SLO alerting + health snapshots.

Raw counters can't answer "are we burning the error budget *right now*?"
— a daemon that served a bad hour yesterday has elevated totals forever.
The standard fix (Google SRE workbook ch.5) is **multi-window burn-rate
alerting**: an alert fires only when the bad-event fraction exceeds
``fire_burn`` x budget over BOTH a fast window (catches the spike, sets
time-to-detect) and a slow window (suppresses blips); it clears with
**hysteresis** — both windows must fall below the lower ``clear_burn``
threshold — so a burn hovering at the boundary produces one transition,
not a flap storm.

:class:`SLOTracker` is pull-based: :meth:`tick` samples cumulative
(total, bad) pairs from registered rules — plain callables, typically
closures over :mod:`repro_torch.obs.metrics` counters — into per-rule sample
deques bounded by the slow window, and runs the state machine.  No
background thread: the serve loop ticks it at the ``--health-every``
cadence, tests tick it with a virtual clock, so alert behaviour is
seeded-deterministic.

Alert transitions emit ``alert_fire:<name>`` / ``alert_clear:<name>``
instants on the ``slo`` trace track and bump the ``slo.alerts`` counter;
burn levels stream into ``slo.burn_fast`` / ``slo.burn_slow`` gauges.
:func:`health_snapshot` assembles the one JSON document an operator (or
the fabric drill's CI gate) polls: alert states, burn levels, quality
rollup, drift summary, and the full metrics snapshot.
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class BurnRule:
    """One SLO stream: ``bad_fn()``/``total_fn()`` return CUMULATIVE
    counts; ``budget`` is the allowed bad fraction (the SLO's error
    budget); burn = (windowed bad fraction) / budget."""
    name: str
    total_fn: Callable[[], float]
    bad_fn: Callable[[], float]
    budget: float = 0.01
    fast_s: float = 60.0
    slow_s: float = 300.0
    fire_burn: float = 2.0
    clear_burn: float = 1.0
    min_events: int = 1          # windows with fewer totals read burn 0


@dataclass
class AlertState:
    state: str = "ok"            # "ok" | "firing"
    since: float = 0.0
    fires: int = 0
    clears: int = 0
    fast_burn: float = 0.0
    slow_burn: float = 0.0

    def asdict(self) -> dict:
        return {"state": self.state, "since": self.since,
                "fires": self.fires, "clears": self.clears,
                "fast_burn": self.fast_burn, "slow_burn": self.slow_burn}


class SLOTracker:
    """Pull-based multi-window burn-rate alerter (see module doc)."""

    def __init__(self, *, metrics=None, trace=None, clock=time.monotonic):
        self.metrics = metrics
        self.trace = trace
        self.clock = clock
        # lint: bounded-by(config-time rule registration, not a hot path)
        self._rules: list[BurnRule] = []
        self._samples: dict[str, deque] = {}
        self.alerts: dict[str, AlertState] = {}

    def add_rule(self, rule: BurnRule) -> None:
        assert rule.name not in self.alerts, f"duplicate rule {rule.name}"
        self._rules.append(rule)
        self._samples[rule.name] = deque()
        self.alerts[rule.name] = AlertState()

    def _burn(self, dq: deque, now: float, window: float,
              rule: BurnRule) -> float:
        if not dq:
            return 0.0
        t1, total1, bad1 = dq[-1]
        # baseline: newest sample at or before the window edge; if the
        # tracker is younger than the window, the oldest sample serves —
        # early burns must be visible, not masked by a half-full window
        base = dq[0]
        for s in dq:
            if s[0] <= now - window:
                base = s
            else:
                break
        dt_total = total1 - base[1]
        if dt_total < rule.min_events:
            return 0.0
        frac = max(bad1 - base[2], 0.0) / dt_total
        return frac / max(rule.budget, 1e-12)

    def tick(self, now: Optional[float] = None) -> dict:
        """Sample every rule and run the fire/clear state machine.
        Returns {rule: state} for convenience."""
        now = self.clock() if now is None else now
        out = {}
        for rule in self._rules:
            dq = self._samples[rule.name]
            dq.append((now, float(rule.total_fn()), float(rule.bad_fn())))
            # evict: keep exactly one sample older than the slow window
            while len(dq) >= 2 and dq[1][0] <= now - rule.slow_s:
                dq.popleft()
            st = self.alerts[rule.name]
            st.fast_burn = self._burn(dq, now, rule.fast_s, rule)
            st.slow_burn = self._burn(dq, now, rule.slow_s, rule)
            if st.state == "ok" and st.fast_burn >= rule.fire_burn \
                    and st.slow_burn >= rule.fire_burn:
                st.state, st.since, st.fires = "firing", now, st.fires + 1
                self._transition(rule.name, "fire", now, st)
            elif st.state == "firing" and st.fast_burn <= rule.clear_burn \
                    and st.slow_burn <= rule.clear_burn:
                st.state, st.since = "ok", now
                st.clears += 1
                self._transition(rule.name, "clear", now, st)
            if self.metrics is not None:
                self.metrics.gauge("slo.burn_fast").set(
                    st.fast_burn, label=rule.name)
                self.metrics.gauge("slo.burn_slow").set(
                    st.slow_burn, label=rule.name)
                self.metrics.gauge("slo.alert").set(
                    1.0 if st.state == "firing" else 0.0, label=rule.name)
            out[rule.name] = st.state
        return out

    def _transition(self, name: str, kind: str, now: float,
                    st: AlertState) -> None:
        if self.metrics is not None:
            self.metrics.counter("slo.alerts").inc(1.0, f"{name}:{kind}")
        if self.trace is not None:
            self.trace.instant(
                f"alert_{kind}:{name}", t=now, track="slo",
                args={"fast_burn": round(st.fast_burn, 3),
                      "slow_burn": round(st.slow_burn, 3)})

    def snapshot(self) -> dict:
        return {name: st.asdict() for name, st in self.alerts.items()}


def default_rules(tracker: SLOTracker, registry, *, quality=None,
                  fast_s: float = 60.0, slow_s: float = 300.0) -> None:
    """Wire the standard serving SLO streams onto a tracker:

    * ``deadline`` — degraded completions (admission traded quality for
      the deadline) against a 5% budget;
    * ``partial``/``failed`` — responses missing clusters or dropped,
      1% and 0.1% budgets;
    * ``shed`` — rejected at admission, 1%;
    * ``quality`` — recall proxy below the monitor's low threshold, 5%
      (only when a :class:`~repro_torch.obs.quality.QualityMonitor` is given).
    """
    comp = registry.counter("engine.completions")

    def rule(name, bad_fn, budget, total_fn=comp.value):
        tracker.add_rule(BurnRule(
            name=name, total_fn=total_fn, bad_fn=bad_fn, budget=budget,
            fast_s=fast_s, slow_s=slow_s))

    rule("deadline", lambda: comp.value("degraded"), 0.05)
    rule("partial", lambda: comp.value("partial"), 0.01)
    rule("failed", lambda: comp.value("failed"), 0.001)
    rule("shed", lambda: comp.value("shed"), 0.01)
    if quality is not None:
        rule("quality", quality.low_proxy.value, 0.05,
             total_fn=quality.queries.value)


def health_snapshot(*, slo: Optional[SLOTracker] = None, quality=None,
                    drift=None, registry=None, extra: Optional[dict] = None,
                    t: Optional[float] = None) -> dict:
    """One JSON-able health document: alert states + burns, quality
    rollup, drift summary, full metrics snapshot.  What ``serve.py
    --health-out`` writes and the fabric drill gates on."""
    doc: dict = {"t": time.time() if t is None else t}
    if slo is not None:
        doc["alerts"] = slo.snapshot()
    if quality is not None:
        doc["quality"] = quality.summary()
    if drift is not None:
        doc["drift"] = drift.summary()
    if registry is not None:
        doc["metrics"] = registry.snapshot()
    if extra:
        doc.update(extra)
    return doc


def write_health(path, doc) -> None:
    """Atomic-enough single-file write for a polling operator."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=float)
    import os
    os.replace(tmp, path)
