#!/usr/bin/env python3
"""The serving CLI's fabric drill with its heartbeat watched.

    PYTHONPATH=src python3 tools/fabric_heartbeat.py --shards 4 \\
        --replicas 2 --kill-shard-at 2 --duration 6 --n 100000 [--device cpu]

Takes ``python -m repro_torch.launch.serve``'s arguments and runs
``run_fabric`` with ``ShardedFabric``'s heartbeat instrumented: each
shard's largest gap between two beats, each failover's seconds since that
shard's last beat and the heartbeat clock then, the number of ticks and
the largest gap between two.  A healthy shard declared dead shows as a
failover of a shard the drill did not kill."""
from __future__ import annotations

import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.distributed import fabric as fm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def main(argv=None) -> dict:
    last, gaps, fails, ticks = {}, {}, [], []
    lock = threading.Lock()
    beat0, fail0, tick0 = (fm.ShardedFabric._beat,
                           fm.ShardedFabric._declare_failed,
                           fm.ShardedFabric._maybe_tick)
    t0 = time.monotonic()

    def beat(self, shard, latency=0.001):
        now = time.monotonic()
        with lock:
            if shard in last:
                gaps[shard] = max(gaps.get(shard, 0.0), now - last[shard])
            last[shard] = now
        return beat0(self, shard, latency)

    def declare(self, shard):
        if shard not in self.failed:
            now = time.monotonic()
            fails.append({"t": now - t0, "shard": shard,
                          "since_beat_s": now - last.get(shard, t0),
                          "clock": self.hb.clock,
                          "last_beat_clock": int(self.hb.last_beat[shard])})
        return fail0(self, shard)

    def tick(self):
        c = self.hb.clock
        tick0(self)
        if self.hb.clock != c:
            ticks.append(time.monotonic())

    fm.ShardedFabric._beat = beat
    fm.ShardedFabric._declare_failed = declare
    fm.ShardedFabric._maybe_tick = tick
    try:
        out = serve.run_fabric(serve.build_parser().parse_args(argv))
    finally:
        fm.ShardedFabric._beat = beat0
        fm.ShardedFabric._declare_failed = fail0
        fm.ShardedFabric._maybe_tick = tick0
    tick_gaps = [b - a for a, b in zip(ticks, ticks[1:])]
    res = {"failovers": fails,
           "max_beat_gap_s": {s: g for s, g in sorted(gaps.items())},
           "ticks": len(ticks), "max_tick_gap_s": max(tick_gaps or [0.0]),
           "partial": out["partial"], "dropped": out["dropped"],
           "kills": out["kills"]}
    print(f"[heartbeat] {res}")
    return res


if __name__ == "__main__":
    main()
