"""nprobe_mean.bulk: ``readers.nprobe_mean`` in the resident f32 cell."""

from anns_bench import readers


def read(run):
    return readers.nprobe_mean(run)
