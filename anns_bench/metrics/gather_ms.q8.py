"""gather_ms.q8: mean milliseconds a batch from the start of the host
tier's union gather to the packed union's arrival on the card (StageTimes
stream_end - gather_start)."""


def read(run):
    ts = [t for t, _ in run.batches if t.stream_end > t.gather_start > 0]
    if not ts:
        return None
    return 1e3 * sum(t.stream_end - t.gather_start for t in ts) / len(ts)
