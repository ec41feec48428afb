"""device_idle.tiered: ``readers.device_idle`` in the tiered q8 cell."""

from anns_bench import readers


def read(run):
    return readers.device_idle(run)
