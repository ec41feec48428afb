"""plan_ms.tiered: ``readers.plan_ms`` in the tiered q8 cell."""

from anns_bench import readers


def read(run):
    return readers.plan_ms(run)
