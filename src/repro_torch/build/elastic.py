"""Elastic construction task runner (copy of ``run_tasks`` from
``repro.build.elastic``): construction tasks are dependency-free and
idempotent, so they run on a thread pool with bounded retries."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable


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
