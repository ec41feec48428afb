"""Where a run's process runs on the host, and what its threads did over
the measured window.

:func:`placement` picks the CPUs a run keeps to: the card's NUMA node, one
logical CPU a physical core, read from sysfs (nothing is written there).
:func:`reading` takes, at the window's start and again at its end, each
thread's CPU time, context switches and last CPU from ``/proc/self/task``,
the calling thread's ``time.thread_time`` and the process's CPU time;
:func:`window_use` is the difference.  Files are read twice: no thread
samples in between.
"""
from __future__ import annotations

import os
import re
import subprocess
import threading
import time
from typing import Optional

TICK = os.sysconf("SC_CLK_TCK")
TOP = 16                 # threads a reading lists, by CPU time


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def cpulist(text: str) -> set:
    """The CPUs of a sysfs CPU list such as ``0-3,8,10-11``."""
    out = set()
    for part in text.strip().split(","):
        if part:
            a, _, b = part.partition("-")
            out.update(range(int(a), int(b or a) + 1))
    return out


def bus_id() -> Optional[str]:
    """The first card's PCI address as sysfs names it (``0000:3b:00.0``),
    from ``nvidia-smi``; None where it gives none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.split()
    except (OSError, subprocess.SubprocessError):
        return None
    m = re.fullmatch(r"([0-9A-Fa-f]{4,8}):([0-9A-Fa-f]{2}):([0-9A-Fa-f]{2})"
                     r"\.([0-7])", out[0]) if out else None
    return m and f"{int(m[1], 16):04x}:{m[2]}:{m[3]}.{m[4]}".lower()


def placement(bus: Optional[str], allowed, sysfs: str = "/sys"
              ) -> tuple[list, str]:
    """The CPUs a run keeps to, and how they were chosen: those of PCI
    device ``bus``'s NUMA node (``local_cpulist``) within ``allowed``, the
    lowest of each physical core's (``thread_siblings_list``); ``allowed``
    itself where a file cannot be read or nothing is left."""
    allowed = set(allowed)
    if not bus:
        return sorted(allowed), "allowed: the card has no PCI address"
    try:
        node = cpulist(_read(f"{sysfs}/bus/pci/devices/{bus}/local_cpulist"))
        keep, cores = [], set()
        for cpu in sorted(node & allowed):
            core = min(cpulist(_read(f"{sysfs}/devices/system/cpu/cpu{cpu}"
                                     "/topology/thread_siblings_list")))
            if core not in cores:
                cores.add(core)
                keep.append(cpu)
    except (OSError, ValueError) as e:
        return sorted(allowed), f"allowed: {type(e).__name__} in sysfs"
    if not keep:
        return sorted(allowed), "allowed: none of the card's node"
    return keep, "the card's node, one CPU a core"


def threads(task: str = "/proc/self/task") -> dict:
    """{tid: (name, cpu_s, voluntary, involuntary, last_cpu)} of each of
    the process's threads: CPU seconds (``stat``'s utime and stime), context
    switches (``status``; 0 where the kernel shows none) and the CPU it last
    ran on.  The name is the Python thread's where there is one.  A thread
    that ends while it is read is left out."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    out = {}
    for tid in os.listdir(task):
        try:
            stat = _read(f"{task}/{tid}/stat")
            status = _read(f"{task}/{tid}/status")
        except OSError:
            continue
        f = stat[stat.rindex(")") + 2:].split()   # from field 3, state
        cs = {k: int(v) for k, _, v in (line.partition(":") for line in
                                          status.splitlines())
              if k.endswith("ctxt_switches")}
        out[int(tid)] = (
            names.get(int(tid), stat[stat.index("(") + 1:stat.rindex(")")]),
            (int(f[11]) + int(f[12])) / TICK,
            cs.get("voluntary_ctxt_switches", 0),
            cs.get("nonvoluntary_ctxt_switches", 0), int(f[36]))
    return out


def thread_use(before: dict, after: dict, top: int = TOP) -> list:
    """[name, tid, cpu_s, voluntary, involuntary, last_cpu] of each thread
    over the time between two :func:`threads` readings, busiest first; a
    thread started in between counts from nothing, one that ended is not
    in ``after``."""
    rows = []
    for tid, (name, cpu, vol, inv, last) in after.items():
        _, cpu0, vol0, inv0, _ = before.get(tid, (name, 0.0, 0, 0, last))
        if cpu > cpu0 or vol > vol0 or inv > inv0:
            rows.append([name, tid, round(cpu - cpu0, 3), vol - vol0,
                         inv - inv0, last])
    rows.sort(key=lambda r: (-r[2], -r[3]))
    return rows[:top]


def reading() -> tuple:
    """What :func:`window_use` compares: the threads, the calling thread's
    CPU time and the whole process's (threads that ended included)."""
    t = os.times()
    return threads(), time.thread_time(), t.user + t.system


def window_use(start: tuple) -> dict:
    """The host's use between :func:`reading` ``start`` and now: each
    thread's (:func:`thread_use`), the calling thread's CPU seconds
    (``caller_cpu_s``, ``time.thread_time``), the process's, and the CPUs
    the process may run on."""
    th, caller, proc = reading()
    return {"threads": thread_use(start[0], th),
            "caller_cpu_s": caller - start[1],
            "process_cpu_s": proc - start[2],
            "cpus_allowed": sorted(os.sched_getaffinity(0))}
