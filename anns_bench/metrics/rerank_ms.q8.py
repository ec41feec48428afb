"""rerank_ms.q8: mean milliseconds a batch of the flash-tier exact re-rank
(StageTimes rerank_end - rerank_start)."""


def read(run):
    ts = [t for t, _ in run.batches if t.rerank_end > t.rerank_start > 0]
    if not ts:
        return None
    return 1e3 * sum(t.rerank_end - t.rerank_start for t in ts) / len(ts)
