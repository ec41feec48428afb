"""Load generation for the serving runtime — the traffic side of §4.1.

A frozen copy of ``repro_torch/runtime/loadgen.py``, kept inside the
benchmark so that a change to the program cannot move the yardstick.

The paper evaluates its userspace I/O stack under production query streams
("heavy traffic from millions of users"): open-loop arrival processes that
keep issuing work whether or not the server keeps up (the back-pressure /
admission-control regime), and closed-loop clients that wait for their
previous answer (the latency-measurement regime).  This module generates
deterministic, seeded versions of both:

* ``poisson_trace``    — memoryless open-loop arrivals at a target QPS;
* ``bursty_trace``     — piecewise-Poisson on/off bursts (the diurnal +
                         flash-crowd shape of Fig. 1 traffic);
* ``multi_tenant_trace`` — superposition of per-index traces for the §4.2
                         multi-index node (each tenant its own rate, top-k
                         range, and deadline budget);
* ``locality_skewed_trace`` — ``concurrency`` independent user streams, each
                         pinned (with slow Markov drift) to one contiguous
                         GROUP of the query pool; arrivals from different
                         groups interleave in time, so arrival-order
                         batching mixes groups while locality-aware
                         formation can unmix them (the FIFO-vs-locality
                         A/B's worst case for FIFO, and the shape of real
                         traffic: many concurrent users, each on a topic);
* ``hot_cluster_trace`` — a hot subset of the query pool takes most of the
                         traffic (hot-cluster / celebrity-item skew): the
                         batch union is dominated by a few clusters that
                         every batch re-gathers;
* ``drifting_trace``   — a sliding query-pool window migrates across the
                         cluster space over the trace (distribution drift:
                         what the centroid-drift monitor and recall-proxy
                         histograms are built to catch).

Traces are plain lists of :class:`Arrival` sorted by time — the engine tests
replay them against a virtual clock, so every admission/shedding decision is
reproducible bit-for-bit from (trace seed, policy).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One query arrival: time is seconds from trace start (virtual clock)."""
    t: float
    index: str                     # which co-resident index this query hits
    qrow: int                      # row into the tenant's query pool
    topk: int
    deadline_s: Optional[float]    # latency budget (None = best-effort)

    def deadline_at(self, t0: float) -> Optional[float]:
        return None if self.deadline_s is None else t0 + self.t + self.deadline_s


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Per-tenant traffic shape for multi-index mixes."""
    index: str
    rate_qps: float
    topk_lo: int = 10
    topk_hi: int = 100
    deadline_s: Optional[float] = None
    n_queries: int = 1 << 30       # query-pool size qrow is drawn from


def _draw_arrivals(
    rng: np.random.Generator,
    spec: TenantSpec,
    duration_s: float,
    rate_fn=None,
) -> list[Arrival]:
    """Thinned Poisson process: homogeneous at spec.rate_qps, or modulated by
    ``rate_fn(t) in [0, 1]`` (Lewis–Shedler thinning, so bursty traces stay
    exactly Poisson within each regime)."""
    out: list[Arrival] = []
    t = 0.0
    if spec.rate_qps <= 0:
        return out
    while True:
        t += rng.exponential(1.0 / spec.rate_qps)
        if t >= duration_s:
            break
        if rate_fn is not None and rng.uniform() > rate_fn(t):
            continue
        topk = int(np.exp(rng.uniform(np.log(spec.topk_lo),
                                      np.log(spec.topk_hi + 1))))
        topk = min(max(topk, spec.topk_lo), spec.topk_hi)
        out.append(Arrival(t=float(t), index=spec.index,
                           qrow=int(rng.integers(0, spec.n_queries)),
                           topk=topk, deadline_s=spec.deadline_s))
    return out


def poisson_trace(
    rate_qps: float,
    duration_s: float,
    seed: int = 0,
    index: str = "default",
    topk: tuple[int, int] = (10, 100),
    deadline_s: Optional[float] = None,
    n_queries: int = 1 << 30,
) -> list[Arrival]:
    """Open-loop memoryless arrivals at ``rate_qps`` for ``duration_s``."""
    rng = np.random.default_rng(seed)
    spec = TenantSpec(index, rate_qps, topk[0], topk[1], deadline_s, n_queries)
    return _draw_arrivals(rng, spec, duration_s)


def bursty_trace(
    base_qps: float,
    burst_qps: float,
    period_s: float,
    duty: float,
    duration_s: float,
    seed: int = 0,
    index: str = "default",
    topk: tuple[int, int] = (10, 100),
    deadline_s: Optional[float] = None,
    n_queries: int = 1 << 30,
) -> list[Arrival]:
    """On/off bursts: ``burst_qps`` for the first ``duty`` fraction of every
    ``period_s`` window, ``base_qps`` otherwise (flash-crowd shape)."""
    rng = np.random.default_rng(seed)
    peak = max(base_qps, burst_qps)
    spec = TenantSpec(index, peak, topk[0], topk[1], deadline_s, n_queries)

    def rate_fn(t: float) -> float:
        in_burst = (t % period_s) < duty * period_s
        return (burst_qps if in_burst else base_qps) / peak

    return _draw_arrivals(rng, spec, duration_s, rate_fn)


def locality_skewed_trace(
    rate_qps: float,
    duration_s: float,
    n_queries: int,
    n_groups: int = 16,
    concurrency: int = 8,
    switch_p: float = 0.02,
    seed: int = 0,
    index: str = "default",
    topk: tuple[int, int] = (10, 100),
    deadline_s: Optional[float] = None,
) -> list[Arrival]:
    """Locality-skewed open-loop arrivals: ``concurrency`` independent
    Poisson user streams (rate_qps split evenly), each drawing qrows from
    ONE of ``n_groups`` contiguous slices of the query pool and switching to
    a fresh random group with probability ``switch_p`` per arrival (slow
    topic drift).  Callers that want qrow-contiguity to mean probe-locality
    sort their query pool by nearest centroid first — then each group is a
    tight probed-cluster neighborhood, and the merged timeline interleaves
    ~``concurrency`` neighborhoods at any instant.  Each stream draws from
    its own derived seed, but note the total rate is split evenly, so
    changing ``concurrency`` reshapes every stream's arrival times (hold it
    fixed across paired A/B runs)."""
    if n_groups <= 0 or n_queries < n_groups:
        raise ValueError(f"need n_queries >= n_groups ({n_queries} < {n_groups})")
    group_size = n_queries // n_groups
    streams = []
    for s in range(max(int(concurrency), 1)):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 11, s]))
        spec = TenantSpec(index, rate_qps / max(int(concurrency), 1),
                          topk[0], topk[1], deadline_s, n_queries)
        raw = _draw_arrivals(rng, spec, duration_s)
        g = int(rng.integers(0, n_groups))
        out = []
        for a in raw:
            if rng.uniform() < switch_p:
                g = int(rng.integers(0, n_groups))
            qrow = g * group_size + int(rng.integers(0, group_size))
            out.append(dataclasses.replace(a, qrow=qrow))
        streams.append(out)
    return list(heapq.merge(*streams, key=lambda a: a.t))


def hot_cluster_trace(
    rate_qps: float,
    duration_s: float,
    n_queries: int,
    hot_frac: float = 0.05,
    hot_weight: float = 0.9,
    seed: int = 0,
    index: str = "default",
    topk: tuple[int, int] = (10, 100),
    deadline_s: Optional[float] = None,
) -> list[Arrival]:
    """Hot-cluster skew: ``hot_weight`` of the traffic draws qrows from the
    first ``hot_frac`` slice of the query pool, the rest uniformly from the
    whole pool.  With a centroid-sorted pool the hot slice maps to a handful
    of clusters — the celebrity-item regime where most batches should share
    most of their gather union."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 13]))
    spec = TenantSpec(index, rate_qps, topk[0], topk[1], deadline_s, n_queries)
    raw = _draw_arrivals(rng, spec, duration_s)
    n_hot = max(int(n_queries * hot_frac), 1)
    out = []
    for a in raw:
        if rng.uniform() < hot_weight:
            qrow = int(rng.integers(0, n_hot))
        else:
            qrow = int(rng.integers(0, n_queries))
        out.append(dataclasses.replace(a, qrow=qrow))
    return out


def shard_skewed_trace(
    rate_qps: float,
    duration_s: float,
    n_queries: int,
    hot_rows: Sequence[int],
    hot_weight: float = 0.9,
    seed: int = 0,
    index: str = "default",
    topk: tuple[int, int] = (10, 100),
    deadline_s: Optional[float] = None,
) -> list[Arrival]:
    """Shard-skewed arrivals for the fabric drills: ``hot_weight`` of the
    traffic draws qrows from ``hot_rows`` — the caller passes the query rows
    whose nearest centroid lives on ONE shard (``ShardedFabric.
    query_shards``) — the rest uniformly from the whole pool.  One shard
    therefore absorbs most of the fan-out (the replication + kill-drill
    target), and the whole trace is a pure function of ``seed``."""
    hot_rows = np.asarray(hot_rows, np.int64)
    if hot_rows.size == 0:
        raise ValueError("shard_skewed_trace needs a non-empty hot_rows")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 17]))
    spec = TenantSpec(index, rate_qps, topk[0], topk[1], deadline_s, n_queries)
    raw = _draw_arrivals(rng, spec, duration_s)
    out = []
    for a in raw:
        if rng.uniform() < hot_weight:
            qrow = int(hot_rows[int(rng.integers(0, hot_rows.size))])
        else:
            qrow = int(rng.integers(0, n_queries))
        out.append(dataclasses.replace(a, qrow=qrow))
    return out


def drifting_trace(
    rate_qps: float,
    duration_s: float,
    n_queries: int,
    window_frac: float = 0.25,
    seed: int = 0,
    index: str = "default",
    topk: tuple[int, int] = (10, 100),
    deadline_s: Optional[float] = None,
) -> list[Arrival]:
    """Distribution-drift arrivals for the quality-observability drills: a
    contiguous window of ``window_frac`` of the query pool slides from the
    pool's start to its end over the trace duration, and every qrow is
    drawn from the CURRENT window.  With a centroid-sorted pool the query
    distribution therefore migrates across the cluster space — early
    traffic probes the first clusters, late traffic the last — which is
    the workload shape the centroid-drift monitor and the per-route
    recall-proxy histograms exist to catch.  Pure function of ``seed``."""
    if not 0.0 < window_frac <= 1.0:
        raise ValueError(f"window_frac must be in (0, 1], got {window_frac}")
    win = max(int(n_queries * window_frac), 1)
    span = max(n_queries - win, 0)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 19]))
    spec = TenantSpec(index, rate_qps, topk[0], topk[1], deadline_s,
                      n_queries)
    raw = _draw_arrivals(rng, spec, duration_s)
    out = []
    for a in raw:
        lo = int(span * min(a.t / max(duration_s, 1e-9), 1.0))
        qrow = lo + int(rng.integers(0, win))
        out.append(dataclasses.replace(a, qrow=qrow))
    return out


@dataclasses.dataclass(frozen=True)
class UpdateArrival:
    """One update-lane arrival (lifecycle ingest): an insert of ``n`` new
    vectors or a delete of ``n`` live ids, at trace time ``t``."""
    t: float
    op: str                        # "insert" | "delete"
    n: int = 1
    index: str = "default"


def update_trace(
    insert_ops_s: float,
    delete_ops_s: float,
    duration_s: float,
    seed: int = 0,
    index: str = "default",
    batch: int = 1,
) -> list[UpdateArrival]:
    """Open-loop update stream: independent Poisson insert/delete processes,
    time-merged.  ``batch`` vectors/ids ride each op (the client-side
    batching real ingest pipelines do).  Seeded per-op-type so changing one
    rate does not perturb the other stream's arrivals."""
    streams = []
    for i, (op, rate) in enumerate((("insert", insert_ops_s),
                                    ("delete", delete_ops_s))):
        if rate <= 0:
            continue
        rng = np.random.default_rng(np.random.SeedSequence([seed, 7, i]))
        out, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= duration_s:
                break
            out.append(UpdateArrival(t=float(t), op=op, n=batch, index=index))
        streams.append(out)
    return list(heapq.merge(*streams, key=lambda a: a.t))


def merge_timelines(*traces):
    """Time-merge heterogeneous arrival lists (search + update) into one
    replayable stream — every element keeps its own type, sorted by .t."""
    return list(heapq.merge(*traces, key=lambda a: a.t))


def multi_tenant_trace(
    tenants: Sequence[TenantSpec],
    duration_s: float,
    seed: int = 0,
) -> list[Arrival]:
    """Superposition of independent per-tenant Poisson streams, time-merged.

    Each tenant gets a derived seed, so adding a tenant does not perturb the
    other tenants' arrivals (important for fairness A/Bs)."""
    streams = []
    for i, spec in enumerate(tenants):
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        streams.append(_draw_arrivals(rng, spec, duration_s))
    return list(heapq.merge(*streams, key=lambda a: a.t))
