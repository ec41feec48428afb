"""device_idle.build: ``readers.device_idle`` over the build window."""

from anns_bench import readers


def read(run):
    return readers.device_idle(run)
