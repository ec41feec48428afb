"""take_ms.q8: mean milliseconds a batch the host tier spends copying the
union's rows into its pinned buffers (``np.take``) and pinning the remap
(StageTimes gather_end - alloc_end: the ``gather.take`` span).  In a traced
run it also keeps the device's idle time by the batches' spans for the log
(``spans.keep_idle_split``)."""

from anns_bench import spans


def read(run):
    spans.keep_idle_split(run)
    return spans.mean_ms(run, "alloc_end", "gather_end")
