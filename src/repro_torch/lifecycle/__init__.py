"""Index lifecycle (port of ``repro.lifecycle``): epoch-tagged index
versions, so an engine swaps in a rebuilt index while in-flight batches
finish on the old epoch, which retires (and frees its posting tier) when
its last batch harvests; and the update lane (``ingest``): a delta buffer
and tombstones published as immutable snapshots that the serving
pipeline's freshness merge reads.  The delta rebuild and its scheduler
(``rebuild``) and the drift monitor (``drift``) are not ported yet."""
from .ingest import (
    FreshSnapshot, LiveFreshState, UpdateCompletion, UpdateLane,
    UpdateLaneStats, UpdateRequest,
)
from .version import Epoch, EpochRecord, VersionManager
