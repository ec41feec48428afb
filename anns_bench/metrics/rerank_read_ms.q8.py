"""rerank_read_ms.q8: mean milliseconds a batch the flash re-rank waits on
its reads of the flash tier (StageTimes rerank_read_wait_s, summed over
its rounds: the ``rerank.read_wait`` span)."""

from anns_bench import spans


def read(run):
    ts = [t for t in spans.batch_stamps(run, "rerank_read_wait_s")
          if t.rerank_end > t.rerank_start > 0.0]
    if not ts:
        return None
    return 1e3 * sum(t.rerank_read_wait_s for t in ts) / len(ts)
