"""Elastic construction pool (a copy of ``repro.build.elastic``, paper
§5.2 / Fig. 21b).

Construction tasks are dependency-free and idempotent, so the paper runs
them on cheap preemptible workers with retry/evict/backup policies.  Two
layers:

* ``run_tasks``: the real executor, a thread pool with bounded retries for
  transient failures (preemptions surface as exceptions);
* ``SimPool``: a discrete-event model of the same policies at 10^4-worker
  scale (preemption, flaky-node eviction, straggler backups), which gives
  the Fig. 21b makespan-against-workers curve without a cluster.  It draws
  from ``np.random.default_rng(policy.seed)`` in the reference's order, so
  the same seed and inputs give the reference's report.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np


class TaskFailed(RuntimeError):
    """A task exhausted its retry budget."""


def run_tasks(fns: list[Callable], n_workers: int = 2,
              max_attempts: int = 3) -> list:
    """Run callables on a thread pool; retry each up to ``max_attempts``.

    Returns results in input order; raises TaskFailed when a task keeps
    failing (construction is idempotent, so retries are safe).
    """

    def attempt(fn):
        last = None
        for _ in range(max_attempts):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — preemptions are generic
                last = e
        raise TaskFailed(f"task failed after {max_attempts} attempts") from last

    with ThreadPoolExecutor(max_workers=max(1, n_workers)) as pool:
        futs = [pool.submit(attempt, fn) for fn in fns]
        return [f.result() for f in futs]


# --------------------------------------------------------------------------
# discrete-event pool simulator
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SimTask:
    tid: int
    work: float = 1.0


@dataclasses.dataclass
class SimNode:
    nid: int
    preempt_rate: float = 0.0   # P(an execution on this node is preempted)
    speed: float = 1.0          # work units per time unit


@dataclasses.dataclass
class PoolPolicy:
    seed: int = 0
    evict_after: int = 8            # preemptions before a node is evicted
    straggler_factor: Optional[float] = 2.0  # backup when projected runtime
                                             # exceeds factor * task.work;
                                             # None = backups off
    requeue_front: bool = True      # preempted tasks go to the queue front


@dataclasses.dataclass
class PoolReport:
    makespan: float
    task_node: dict               # tid -> nid that FINISHED the task
    n_preemptions: int
    n_reassignments: int
    n_evictions: int
    n_backups: int


class SimPool:
    """Event-driven simulation of the elastic pool policies."""

    def __init__(self, nodes: list[SimNode], policy: PoolPolicy):
        self.nodes = list(nodes)
        self.policy = policy

    def run(self, tasks: list[SimTask]) -> PoolReport:
        rng = np.random.default_rng(self.policy.seed)
        queue: deque[SimTask] = deque(tasks)
        events: list = []          # (time, seq, kind, node, task)
        seq = 0
        done: dict[int, float] = {}
        task_node: dict[int, int] = {}
        running: dict[int, tuple[SimNode, float, float]] = {}  # primary copy
        backed_up: set[int] = set()
        preempts: dict[int, int] = {}
        evicted: set[int] = set()
        idle: set[int] = set()
        node_by_id = {n.nid: n for n in self.nodes}
        stats = dict(pre=0, reassign=0, evict=0, backup=0)
        makespan = 0.0

        def launch(task: SimTask, node: SimNode, now: float, primary: bool):
            nonlocal seq
            idle.discard(node.nid)
            dur = task.work / max(node.speed, 1e-9)
            if rng.random() < node.preempt_rate:
                t_end = now + dur * float(rng.uniform(0.1, 0.9))
                kind = "preempt"
            else:
                t_end = now + dur
                kind = "finish"
            seq += 1
            heapq.heappush(events, (t_end, seq, kind, node, task))
            if primary:
                running[task.tid] = (node, now, now + dur)

        def dispatch(node: SimNode, now: float):
            """Give an available node work: queued task, else a straggler
            backup, else park it idle."""
            if node.nid in evicted:
                return
            if queue:
                launch(queue.popleft(), node, now, primary=True)
                return
            sf = self.policy.straggler_factor
            if sf is not None:
                worst_task, worst_end = None, -1.0
                for tid, (pnode, start, proj) in running.items():
                    if tid in done or tid in backed_up or pnode is node:
                        continue
                    task = task_by_id[tid]
                    if (proj - start) > sf * task.work and proj > worst_end:
                        worst_task, worst_end = task, proj
                if worst_task is not None:
                    backed_up.add(worst_task.tid)
                    stats["backup"] += 1
                    launch(worst_task, node, now, primary=False)
                    return
            idle.add(node.nid)

        def drain_idle(now: float):
            while queue and idle:
                nid = idle.pop()
                launch(queue.popleft(), node_by_id[nid], now, primary=True)

        task_by_id = {t.tid: t for t in tasks}
        for node in self.nodes:
            if not queue:
                idle.add(node.nid)
                continue
            launch(queue.popleft(), node, 0.0, primary=True)

        while events:
            now, _, kind, node, task = heapq.heappop(events)
            if task.tid in done:        # backup race loser / stale preempt
                dispatch(node, now)
            elif kind == "finish":
                done[task.tid] = now
                task_node[task.tid] = node.nid
                running.pop(task.tid, None)
                makespan = max(makespan, now)
                dispatch(node, now)
            else:  # preempt
                stats["pre"] += 1
                preempts[node.nid] = preempts.get(node.nid, 0) + 1
                if running.get(task.tid, (node, 0, 0))[0] is node:
                    running.pop(task.tid, None)
                    stats["reassign"] += 1
                    if self.policy.requeue_front:
                        queue.appendleft(task)
                    else:
                        queue.append(task)
                if (self.policy.evict_after
                        and preempts[node.nid] >= self.policy.evict_after):
                    evicted.add(node.nid)
                    idle.discard(node.nid)
                    stats["evict"] += 1
                else:
                    dispatch(node, now)
                drain_idle(now)
            if not events and queue:
                # every node evicted with work left: the pool re-provisions
                # (paper: replacement preemptibles join); progress guaranteed
                evicted.clear()
                preempts.clear()
                for cand in self.nodes:
                    if queue:
                        launch(queue.popleft(), cand, now, primary=True)
                    else:
                        idle.add(cand.nid)
        return PoolReport(
            makespan=makespan,
            task_node=task_node,
            n_preemptions=stats["pre"],
            n_reassignments=stats["reassign"],
            n_evictions=stats["evict"],
            n_backups=stats["backup"],
        )
