"""batch_queries.tiered: ``readers.batch_queries`` in the tiered q8 cell."""

from anns_bench import readers


def read(run):
    return readers.batch_queries(run)
