#!/usr/bin/env python3
"""``chip_smoke.py``'s live rebuild (phase 13) alone, with the serving
poller and the rebuild thread watched.

    python3 tools/rebuild_gaps.py [--n 1000000] [--device cuda] \
        [--sample-ms 2]

Runs the smoke's phases 1, 3 and 4 (the card, the 1M build, q8 serving)
and then phase 13, while a sampler thread reads the stacks of the
``serve-poller`` and ``rebuild-sched`` threads every ``--sample-ms`` (0:
no sampler; the sampler takes the interpreter lock itself and slows the
poller).  For each of the rebuild's windows (before, snapshot, build,
swap, after) it prints each thread's most sampled innermost frames of
this repository, and the sampler's own largest lateness: a sampler that
wakes hundreds of ms late waited for the interpreter lock.  The windows
are the ones phase 13 records (``chip_smoke.REBUILD_WINDOWS``), also when
its checks fail; its ``[rebuild]`` line carries the poller's longest gap
between SQ drains and the SQ's peak length per window, from the engine's
own ``drain_log``.  Nothing of the program is patched: the sampler only
reads the threads' frames.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

WATCHED = ("serve-poller", "rebuild-sched")


def frame_key(frame) -> str:
    """The innermost frame of this repository (else the innermost one)."""
    f, first = frame, None
    while f is not None:
        code = f.f_code
        if first is None:
            first = f"{os.path.basename(code.co_filename)}:{code.co_name}" \
                    f":{f.f_lineno}"
        if ROOT in code.co_filename:
            return (f"{os.path.relpath(code.co_filename, ROOT)}:"
                    f"{code.co_name}:{f.f_lineno}")
        f = f.f_back
    return first or "?"


class Sampler:
    def __init__(self, period_s: float = 0.002):
        self.period_s = period_s
        self.samples: list = []        # (t, lateness_s, {thread: frame})
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stack-sampler")

    def _run(self) -> None:
        nxt = time.monotonic()
        while not self._stop.is_set():
            nxt += self.period_s
            time.sleep(max(0.0, nxt - time.monotonic()))
            now = time.monotonic()
            late = now - nxt
            if late > self.period_s:
                nxt = now
            names = {t.ident: t.name for t in threading.enumerate()
                     if t.name in WATCHED}
            frames = sys._current_frames()
            self.samples.append((now, late, {
                names[i]: frame_key(fr) for i, fr in frames.items()
                if i in names}))

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def report(samples: list, windows: dict) -> None:
    for win, (lo, hi) in windows.items():
        inside = [s for s in samples if lo <= s[0] < hi]
        if not inside:
            continue
        late = max(s[1] for s in inside) * 1e3
        cs.log(f"[gaps] {win}: {len(inside)} samples, the sampler's largest "
               f"lateness {late:.1f} ms")
        for name in WATCHED:
            cnt = collections.Counter(s[2].get(name, "-") for s in inside)
            top = ", ".join(f"{k} x{v}" for k, v in cnt.most_common(6))
            cs.log(f"[gaps]   {name}: {top}")


def main(argv=None) -> int:
    import shutil

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=cs.N_BASE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sample-ms", type=float, default=2.0)
    args = ap.parse_args(argv)
    cs.N_BASE = args.n
    cs.DEVICE = args.device
    cs.phase_device()
    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sampler = Sampler(args.sample_ms / 1e3) if args.sample_ms > 0 else None
    served = None
    try:
        built = cs.phase_build(work)
        served = cs.phase_serve(work, built)
        if sampler is not None:
            sampler.start()
        try:
            cs.phase_rebuild(work, built, served)
        finally:
            if sampler is not None:
                sampler.stop()
                report(sampler.samples, cs.REBUILD_WINDOWS)
    finally:
        if served is not None:
            served["pipe"].close()
            served["pipe"].flash.release()
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
