"""Storage tiers (port of ``repro.storage``): the chunk arena and index
layout bookkeeping, the host hot tiers (q8 and f32 postings) and the flash
tier for the exact re-rank."""
from .arena import ChunkArena, Extent, OutOfSpace, LBA_BYTES
from .layout import (
    IndexMeta,
    ReplicaMap,
    Striping,
    apply_striping,
    make_replica_map,
    plan_striping,
)
from .host_tier import (
    FetchEvent,
    QuantizedTieredPostings,
    TieredPostings,
    TierStats,
)
from .flash_tier import FlashStats, FlashTier, ReadEvent
