"""Index lifecycle (port of ``repro.lifecycle``): epoch-tagged index
versions, so an engine swaps in a rebuilt index while in-flight batches
finish on the old epoch, which retires (and frees its posting tier) when
its last batch harvests.  Ingest, rebuild and drift are not ported yet."""
from .version import Epoch, EpochRecord, VersionManager
