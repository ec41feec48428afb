"""Index lifecycle (port of ``repro.lifecycle``): epoch-tagged index
versions (``version``), so an engine swaps in a rebuilt index while
in-flight batches finish on the old epoch, which retires (and frees its
posting tier) when its last batch harvests; the update lane (``ingest``): a
delta buffer and tombstones published as immutable snapshots that the
serving pipeline's freshness merge reads; the delta rebuild and its
scheduler (``rebuild``), which fold the delta into a new epoch while the
engine serves; and the drift monitor (``drift``), the rebuild's quality
trigger."""
from .drift import DriftMonitor
from .ingest import (
    FreshSnapshot, LiveFreshState, UpdateCompletion, UpdateLane,
    UpdateLaneStats, UpdateRequest,
)
from .rebuild import (
    CorpusStore, RebuildPolicy, RebuildReport, RebuildScheduler, delta_build,
    load_manifest, q8_rebuild_hook, save_manifest,
)
from .version import Epoch, EpochRecord, VersionManager
