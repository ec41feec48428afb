"""plan_ms.bulk: ``readers.plan_ms`` in the resident f32 cell."""

from anns_bench import readers


def read(run):
    return readers.plan_ms(run)
