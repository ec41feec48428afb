"""The array-backed ``Client`` and ``closed_loop`` against the list-backed
ones they replaced (kept here as the reference), on a scripted engine:
the same ``Run`` fields, requests never answered included."""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np
import pytest

from anns_bench import harness

K = 4


@dataclasses.dataclass
class Comp:
    req_id: int
    status: str
    ids: Optional[np.ndarray]
    nprobe: int
    completed: float


class ScriptedEngine:
    """Numbers requests from ``first`` on; each poll answers up to ``per``
    of the oldest open requests, in a scrambled order.  A request id ``r`` is never
    answered when ``r % drop == 1``, is shed (no ids) when ``r % 11 == 3``
    and degraded (ids) when ``r % 7 == 2``."""

    def __init__(self, first: int = 5, per: int = 7, drop: int = 0):
        self.ids = itertools.count(first)
        self.per, self.drop = per, drop
        self.open: list = []
        self.t = 100.0
        self.qp = self

    def clock(self) -> float:
        return self.t

    def submit(self, query, topk, index=None, block=False) -> int:
        assert index == "ix" and block and topk == K
        rid = next(self.ids)
        if not (self.drop and rid % self.drop == 1):
            self.open.append((rid, int(query[0])))
        return rid

    def wait_completions(self, n=1, timeout=None) -> bool:
        return bool(self.open)

    def poll(self, max_n=0) -> list:
        now, self.open = self.open[:self.per], self.open[self.per:]
        out = []
        for rid, row in sorted(now, key=lambda o: o[0] * 37 % 17):
            self.t += 0.25
            status = "shed" if rid % 11 == 3 else \
                "degraded" if rid % 7 == 2 else "ok"
            ids = None if status == "shed" else \
                np.arange(row, row + K + 2, dtype=np.int32)
            out.append(Comp(rid, status, ids, rid % 5 + 1, self.t))
        return out


class ListClient:
    """The list-backed client as it was: one list per field, a dict from
    request id to record."""

    def __init__(self, eng, name, pool, topk):
        self.eng, self.name, self.pool, self.topk = eng, name, pool, topk
        self.due, self.rows, self.done = [], [], []
        self.ok, self.nprobe, self.ids = [], [], []
        self.slot = {}
        self.off = time.perf_counter() - eng.clock()

    @property
    def outstanding(self):
        return len(self.slot)

    def submit(self, row, due, topk=None):
        i = len(self.rows)
        self.rows.append(row)
        self.due.append(due)
        self.done.append(float("inf"))
        self.ok.append(False)
        self.nprobe.append(0)
        self.ids.append(None)
        rid = self.eng.submit(self.pool[row], topk or self.topk,
                              index=self.name, block=True)
        self.slot[rid] = i
        return i

    def poll(self, timeout):
        self.eng.qp.wait_completions(1, timeout=timeout)
        out = []
        for c in self.eng.qp.poll():
            i = self.slot.pop(c.req_id)
            self.done[i] = c.completed + self.off
            self.ok[i] = c.status == "ok" and c.ids is not None
            self.nprobe[i] = c.nprobe
            self.ids[i] = c.ids
            out.append(i)
        return out

    def wait_all(self, until):
        while self.outstanding and time.perf_counter() < until:
            self.poll(0.05)

    def into(self, run):
        k = self.topk
        run.due = np.asarray(self.due)
        run.done = np.asarray(self.done)
        run.ok = np.asarray(self.ok)
        run.rows = np.asarray(self.rows, np.int64)
        run.nprobe = np.asarray(self.nprobe, np.int64)
        run.ids = np.stack([np.full(k, -1, np.int64) if a is None
                            else np.asarray(a[:k], np.int64)
                            for a in self.ids])


def list_closed_loop(client, order, callers, block, pos, n_blocks):
    left, owner = [0] * callers, {}
    issued = 0

    def issue(c):
        nonlocal pos, issued
        t = time.perf_counter()
        for j in range(block):
            owner[client.submit(int(order[(pos + j) % len(order)]), t)] = c
        pos += block
        left[c] = block
        issued += 1

    for c in range(callers):
        if issued < n_blocks:
            issue(c)
    while issued < n_blocks:
        for i in client.poll(0.01):
            c = owner.pop(i)
            left[c] -= 1
            if left[c] == 0 and issued < n_blocks:
                issue(c)
    return pos


@pytest.fixture
def clock(monkeypatch):
    """A host clock that moves 1 s a reading; calling the fixture starts it
    again at 1000, so both clients read the same times."""
    ticks = [itertools.count(1000)]
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks[0])))
    return lambda: ticks.__setitem__(0, itertools.count(1000))


POOL = np.arange(40, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
FIELDS = ("due", "done", "ok", "rows", "nprobe", "ids")


def _run(client):
    run = harness.Run(None, 0, 0.0, False)
    client.into(run)
    return run


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("callers,block,n_blocks,per", [
    (1, 5, 3, 7), (3, 4, 9, 7), (4, 16, 12, 7), (6, 3, 20, 40)])
def test_closed_loop_records_match_the_list_client(clock, callers, block,
                                                   n_blocks, per):
    order = np.random.default_rng(callers).permutation(len(POOL))
    runs, ends = [], []
    for make, loop in ((ListClient, list_closed_loop),
                       (harness.Client, harness.closed_loop)):
        clock()
        c = make(ScriptedEngine(per=per), "ix", POOL, K)
        ends.append(loop(c, order, callers, block, 3, n_blocks=n_blocks))
        c.wait_all(float("inf"))
        runs.append(_run(c))
    assert ends[0] == ends[1] == 3 + block * n_blocks
    _same(*runs)
    run = runs[1]
    assert run.rows.size == block * n_blocks and np.isfinite(run.done).all()
    shed = (run.ids == -1).all(1)
    assert shed.any() and not run.ok[shed].any()
    assert (~run.ok & ~shed).any()       # degraded: answered with ids


def test_unanswered_requests_keep_inf_and_no_ids(clock):
    runs = []
    for make in (ListClient, harness.Client):
        clock()
        c = make(ScriptedEngine(first=0, drop=4), "ix", POOL, K)
        for r in [*range(0, 30, 3), 31]:
            c.submit(r if make is ListClient else [r], 7.0 + r)
        c.wait_all(time.perf_counter() + 50)
        assert c.outstanding == 3        # ids 1, 5, 9 are never answered
        runs.append(_run(c))
    _same(*runs)
    lost = ~np.isfinite(runs[1].done)
    assert lost.sum() == 3 and (runs[1].ids[lost] == -1).all()
    assert not runs[1].ok[lost].any()


def test_records_grow_past_their_capacity(clock):
    eng = ScriptedEngine(per=1000)
    c = harness.Client(eng, "ix", POOL, K, capacity=4)
    for s in range(0, 37, 6):
        c.submit(np.arange(s, s + 6) % len(POOL), float(s))
    c.wait_all(float("inf"))
    run = _run(c)
    assert run.rows.size == 42 and np.isfinite(run.done).all()
    np.testing.assert_array_equal(run.rows, np.arange(42) % len(POOL))
    np.testing.assert_array_equal(run.due, np.repeat(np.arange(0, 37, 6), 6))


def test_ids_out_of_step_are_refused(clock):
    eng = ScriptedEngine()
    c = harness.Client(eng, "ix", POOL, K)
    c.submit([0, 1], 0.0)
    next(eng.ids)                          # another client's request
    with pytest.raises(RuntimeError, match="not consecutive"):
        c.submit([2], 0.0)
