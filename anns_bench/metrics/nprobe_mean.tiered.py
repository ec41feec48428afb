"""nprobe_mean.tiered: ``readers.nprobe_mean`` in the tiered q8 cell."""

from anns_bench import readers


def read(run):
    return readers.nprobe_mean(run)
