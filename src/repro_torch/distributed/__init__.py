"""Node health and failover planning (port of ``repro.distributed.fault``).
The sharded fabric is not ported yet."""
from .fault import (
    FailoverPlan,
    FaultEvent,
    FaultInjector,
    HeartbeatMonitor,
    ownership_mask,
    plan_failover,
)
