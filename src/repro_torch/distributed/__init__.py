"""Node health, failover planning and the sharded serving fabric (port of
``repro.distributed``'s ``fault`` and ``fabric``): one logical index over S
shard workers behind the engine's stage protocol, with replica failover,
hedging, checksum retries and per-shard epoch retirement."""
from .fabric import FabricStats, ShardNode, ShardReply, ShardTask, ShardedFabric
from .fault import (
    FailoverPlan,
    FaultEvent,
    FaultInjector,
    HeartbeatMonitor,
    ownership_mask,
    plan_failover,
)
