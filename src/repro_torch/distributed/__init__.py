"""Node health, failover planning, the sharded serving fabric, the
collectives and the sharding rules (port of ``repro.distributed``): one
logical index over S shard workers behind the engine's stage protocol, with
replica failover, hedging, checksum retries and per-shard epoch
retirement; the int8 compressed and bucketed all-reduces over a mesh
axis's process group; the ANNS partition specs."""
from .collectives import bucketed_psum, compressed_psum, compressed_psum_tree
from .fabric import FabricStats, ShardNode, ShardReply, ShardTask, ShardedFabric
from .fault import (
    FailoverPlan,
    FaultEvent,
    FaultInjector,
    HeartbeatMonitor,
    ownership_mask,
    plan_failover,
)
from . import sharding
