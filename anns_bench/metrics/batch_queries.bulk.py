"""batch_queries.bulk: ``readers.batch_queries`` in the resident f32 cell."""

from anns_bench import readers


def read(run):
    return readers.batch_queries(run)
