"""qps.tiered: ``readers.qps`` in the tiered q8 cell, whose host gather
and re-rank threads make its runs spread far wider than the resident
cell's, so it has a bound of its own."""

from anns_bench import readers


def read(run):
    return readers.qps(run)
