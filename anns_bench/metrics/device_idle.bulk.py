"""device_idle.bulk: ``readers.device_idle`` in the resident f32 cell."""

from anns_bench import readers


def read(run):
    return readers.device_idle(run)
