"""qps: ``readers.qps`` in the resident f32 cell."""

from anns_bench import readers


def read(run):
    return readers.qps(run)
