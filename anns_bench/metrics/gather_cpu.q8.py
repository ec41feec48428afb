"""gather_cpu.q8: percent of the host tier's union gather (the ``gather``
spans, StageTimes gather_start to gather_end) that its thread spent on a
CPU (``time.thread_time``, StageTimes gather_cpu_s): the rest it waited,
for the interpreter lock or the allocator."""

from anns_bench import spans


def read(run):
    ts = [t for t in spans.batch_stamps(run, "gather_cpu_s")
          if t.gather_end > t.gather_start > 0.0]
    wall = sum(t.gather_end - t.gather_start for t in ts)
    if wall <= 0.0:
        return None
    return 100.0 * sum(t.gather_cpu_s for t in ts) / wall
