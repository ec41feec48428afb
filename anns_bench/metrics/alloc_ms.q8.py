"""alloc_ms.q8: mean milliseconds a batch the host tier spends allocating
the packed union's pinned buffers, between its union plan and its row
copies (StageTimes alloc_end - union_end: the ``gather.alloc`` span)."""

from anns_bench import spans


def read(run):
    return spans.mean_ms(run, "union_end", "alloc_end")
