"""Async serving runtime (port of ``repro.runtime``).

=====================  ====================================================
piece                  runtime module
=====================  ====================================================
SQ/CQ queue pairs,     :mod:`repro_torch.runtime.engine` — bounded
doorbells, polling     submission / completion queues, doorbell conditions,
                       the poller thread with an N-deep in-flight window
gather / scan          :mod:`repro_torch.runtime.pipeline` — plan,
overlap                prefetch, dispatch and harvest stages over the q8,
                       f32 or resident index, on CUDA streams
request coalescing,    :mod:`repro_torch.runtime.batcher` — dynamic
overload control,      micro-batching with probe-overlap (locality)
locality grouping      grouping, deadline-aware shed/degrade admission and
                       round-robin fairness across co-resident indexes
production traffic     :mod:`repro_torch.runtime.loadgen` — seeded Poisson /
                       bursty / multi-tenant / locality-skewed /
                       hot-cluster arrival traces
=====================  ====================================================
"""
from .batcher import BatchPolicy, BatcherStats, DynamicBatcher, MicroBatch
from .engine import (
    Completion,
    EngineStats,
    QueuePair,
    RoutePlan,
    SearchRequest,
    ServeEngine,
    make_route_plan,
    route_requests,
)
from .loadgen import (
    Arrival,
    TenantSpec,
    UpdateArrival,
    bursty_trace,
    drifting_trace,
    hot_cluster_trace,
    locality_skewed_trace,
    merge_timelines,
    multi_tenant_trace,
    poisson_trace,
    shard_skewed_trace,
    update_trace,
)
from .pipeline import (
    BatchResult,
    PrefetchPipeline,
    RerankConfig,
    StageTimes,
    inflight_depth,
    latency_percentiles,
    make_quantized_pipeline,
    max_id_replicas,
    overlap_efficiency,
    rerank_overlap_efficiency,
    stage_spans,
)
