"""One run of one cell: set-up, the measured window, the check, the metrics.

A cell is a workload of ``BENCHMARK.json``: a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<mix>.json``),
with the limits of its comparison in ``limits/<workload>.json``.  Every
metric, end-to-end or per-layer, is read by ``metrics/<name>.py`` from the
:class:`Run` record.  The traffic's ``kind`` picks the driver:

* ``closed``: ``callers`` callers each submit a block of ``block`` pool
  queries through ``ServeEngine.submit`` and wait for the whole block
  before the next; blocks walk a seeded permutation of the pool;
* ``open``: arrivals from the copied load generator (``trace`` names a
  function of :mod:`loadgen`, ``args`` its parameters), each submitted
  when due;
* ``build``: ``build_index`` of the corpus, back to back, whole builds.

A serving window ends ``seconds`` after it starts; callers then stop and
every outstanding request is waited for (a minute at most), so each answer
due in the window is judged.  A build window ends with the first build
that finishes ``seconds`` or more after the start.

Given a ``cache`` directory, a serving cell keeps its built index there
(:func:`system.build_kept`), under its configuration's name and a digest
of the configuration, the data generator, :mod:`system` and the program's
sources: the data set is fixed per configuration, so every run of a
checkout would build the same index, and only the first one does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import check, datagen, loadgen, reference
from .trace import DeviceTrace, Profile

HERE = Path(__file__).resolve().parent
LATE_S = 60.0            # how long after the close an answer is waited for
SAMPLE = 4096            # requests of a serving window the check compares


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, workload: str) -> Cell:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return Cell(workload, _json(HERE / "configs" / f"{w['config']}.json"),
                        _json(HERE / "traffic" / f"{w['traffic']}.json"),
                        _json(HERE / "limits" / f"{workload}.json"),
                        int(w["chips"]))
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"anns_bench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a run leaves for the metric readers."""
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    control: Optional[str] = None            # also judge this control
    cache: Optional[str] = None              # where a built index is kept
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)       # host clock (time.perf_counter)
    due: Optional[np.ndarray] = None         # (R,) when each was due
    done: Optional[np.ndarray] = None        # (R,) completion, inf = never
    ok: Optional[np.ndarray] = None          # (R,) answered "ok"
    rows: Optional[np.ndarray] = None        # (R,) pool row of each
    ids: Optional[np.ndarray] = None         # (R, k) answers
    nprobe: Optional[np.ndarray] = None      # (R,) probes served with
    gt: Optional[np.ndarray] = None          # (pool, k) exact top-k
    batches: list = dataclasses.field(default_factory=list)
    plans: list = dataclasses.field(default_factory=list)
    engine: object = None                    # EngineStats of the window
    builds: list = dataclasses.field(default_factory=list)
    k23: list = dataclasses.field(default_factory=list)
    trace: Optional[DeviceTrace] = None
    info: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------- drivers
class Client:
    """The callers' side of a serving window: submits through the engine,
    collects every completion, one record per request."""

    def __init__(self, eng, name: str, pool: np.ndarray, topk: int):
        self.eng, self.name, self.pool, self.topk = eng, name, pool, topk
        self.due: list = []
        self.rows: list = []
        self.done: list = []
        self.ok: list = []
        self.nprobe: list = []
        self.ids: list = []
        self.slot: dict = {}             # req_id -> record index
        # completions carry the engine's clock; records use the host's
        self.off = time.perf_counter() - eng.clock()

    @property
    def outstanding(self) -> int:
        return len(self.slot)

    def submit(self, row: int, due: float, topk: Optional[int] = None
               ) -> int:
        i = len(self.rows)
        self.rows.append(row)
        self.due.append(due)
        self.done.append(float("inf"))
        self.ok.append(False)
        self.nprobe.append(0)
        self.ids.append(None)
        rid = self.eng.submit(self.pool[row], topk or self.topk,
                              index=self.name, block=True)
        if rid < 0:
            raise RuntimeError("the engine refused a request")
        self.slot[rid] = i
        return i

    def poll(self, timeout: float) -> list[int]:
        """Records completed since the last poll."""
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

    def wait_all(self, until: float) -> None:
        while self.outstanding and time.perf_counter() < until:
            self.poll(0.05)

    def into(self, run: Run) -> None:
        k = self.topk
        run.due = np.asarray(self.due)
        run.done = np.asarray(self.done)
        run.ok = np.asarray(self.ok)
        run.rows = np.asarray(self.rows, np.int64)
        run.nprobe = np.asarray(self.nprobe, np.int64)
        run.ids = np.stack([np.full(k, -1, np.int64) if a is None
                            else np.asarray(a[:k], np.int64)
                            for a in self.ids])


def closed_loop(client: Client, order: np.ndarray, callers: int, block: int,
                pos: int, t_end: Optional[float] = None,
                n_blocks: Optional[int] = None) -> int:
    """Closed-loop callers until ``t_end`` (or ``n_blocks`` blocks are
    issued); returns the next position in ``order``.  Does not wait for
    the last blocks."""
    left, owner = [0] * callers, {}
    issued = 0

    def more() -> bool:
        if n_blocks is not None:
            return issued < n_blocks
        return time.perf_counter() < t_end

    def issue(c: int) -> None:
        nonlocal pos, issued
        t = time.perf_counter()
        for j in range(block):
            owner[client.submit(int(order[(pos + j) % len(order)]), t)] = c
        pos += block
        left[c] = block
        issued += 1

    for c in range(callers):
        if more():
            issue(c)
    while more():
        for i in client.poll(0.01):
            c = owner.pop(i)
            left[c] -= 1
            if left[c] == 0 and more():
                issue(c)
    return pos


def open_loop(client: Client, arrivals: list, t0: float) -> float:
    """Submit each arrival when it is due; returns the largest lateness."""
    late = 0.0
    for a in arrivals:
        due = t0 + a.t
        while True:
            wait = due - time.perf_counter()
            if wait <= 0:
                break
            client.poll(min(wait, 0.002))
        late = max(late, time.perf_counter() - due)
        client.submit(a.qrow % len(client.pool), due, topk=a.topk)
        client.poll(0.0)
    return late


# ---------------------------------------------------------------- cells
def _data(cell: Cell, seed: int, dev):
    d = cell.config["dataset"]
    gen = cell.config["assumed"]["generator"]
    order = seed if cell.traffic.get("permute_rows") else gen["data_seed"]
    x = datagen.corpus(d["n"], d["dim"], gen, order, dev)
    pool = datagen.queries(d["pool"], d["dim"], gen, seed, dev, "pool")
    train = datagen.queries(cell.config["llsp"]["train_queries"], d["dim"],
                            gen, seed, dev, "train")
    return x.cpu().numpy(), pool.cpu().numpy(), train.cpu().numpy()


def _steps(t0: float, marks: dict) -> dict:
    """Seconds of each set-up step from its end stamps."""
    out, prev = {}, t0
    for k, t in marks.items():
        out[k] = t - prev
        prev = t
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _memory_peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def serve_cell(run: Run, sysm, dev, tmp: str) -> dict:
    cfg, tr = run.cell.config, run.cell.traffic
    k = cfg["serve"]["k"]
    t0 = time.perf_counter()
    x, pool, train = _data(run.cell, run.seed, dev)
    marks = {"data": time.perf_counter()}
    if run.cache is None:
        index, llsp, report = sysm.build(x, cfg, os.path.join(tmp, "build"),
                                         train, dev)
    else:
        keep = os.path.join(run.cache, "index",
                            f"{cfg['name']}-{index_digest(run.cell, sysm)}")
        os.makedirs(os.path.dirname(keep), exist_ok=True)
        index, llsp, report, kept = sysm.build_kept(x, cfg, keep, train, dev)
        run.info["index"] = "kept" if kept else "built"
    marks["build"] = time.perf_counter()
    dep = sysm.deploy(index, llsp, x, cfg, tmp, dev)
    marks["deploy"] = time.perf_counter()
    sysm.warm(dep, tr)
    marks["warm_sizes"] = time.perf_counter()
    rng = np.random.default_rng(datagen.subseed(run.seed, "order"))
    order = rng.permutation(len(pool))
    eng = sysm.engine(dep, tr)
    eng.start()
    warm = Client(eng, dep.name, pool, k)
    pos = closed_loop(warm, order, tr["callers"], tr["block"], 0,
                      n_blocks=tr["warm_blocks"])
    warm.wait_all(time.perf_counter() + LATE_S)
    eng.stop()
    _sync(dev)
    marks["warm_blocks"] = time.perf_counter()
    run.setup_s = marks["warm_blocks"] - t0
    run.info["setup"] = _steps(t0, marks)
    run.info["build_stages"] = report.stage_seconds

    rec = sysm.Recorder(dep, plans=run.traced)
    eng = sysm.engine(dep, tr)
    eng.start()
    client = Client(eng, dep.name, pool, k)
    prof = Profile() if run.traced else None
    if prof:
        prof.__enter__()
    w0 = time.perf_counter()
    w1 = w0 + run.seconds
    if tr["kind"] == "closed":
        closed_loop(client, order, tr["callers"], tr["block"], pos, t_end=w1)
    else:
        trace_fn = getattr(loadgen, tr["trace"])
        arrivals = trace_fn(**tr["args"], duration_s=run.seconds,
                            seed=datagen.subseed(run.seed, "arrivals"),
                            index=dep.name, n_queries=len(pool))
        run.info["generator_late_s"] = open_loop(client, arrivals, w0)
        run.info["unanswered_at_close"] = client.outstanding
    client.wait_all(w1 + LATE_S)
    eng.stop()
    if prof:
        prof.__exit__(None, None, None)
    rec.close()
    run.window = (w0, w1)
    run.engine = eng.stats
    run.batches, run.plans = rec.batches, rec.plans
    client.into(run)
    if prof:
        run.trace = prof.result(run.window)
    peak = _memory_peak(dev)

    # the program's state goes before the reference runs
    idx = {"centroids": index.centroids.detach().clone(),
           "posting_ids": index.posting_ids.detach().clone()}
    trees = sysm.llsp_trees(llsp)
    dep.pipeline.close()
    if dep.pipeline.flash is not None:
        dep.pipeline.flash.release()
    del dep, index, eng, rec
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    reference.f32_products()
    xd = torch.from_numpy(x).to(dev)
    qd = torch.from_numpy(pool).to(dev)
    run.gt = reference.exact_knn(qd, xd, k).cpu().numpy()
    answered = np.flatnonzero(np.isfinite(run.done))
    rng = np.random.default_rng(datagen.subseed(run.seed, "sample"))
    pick = np.sort(rng.choice(answered, min(SAMPLE, answered.size),
                              replace=False))
    numbers = check.serve_numbers(
        qd[torch.from_numpy(run.rows[pick]).to(dev)], xd, idx, trees, cfg,
        torch.from_numpy(run.ids[pick]).to(dev),
        torch.from_numpy(run.nprobe[pick]).to(dev))
    failed = int((~run.ok).sum())
    numbers["failed"] = float(failed)
    if run.traced:
        run.info["probe_ceiling"] = probe_ceiling(
            qd[:512], xd, idx, run.gt[:512], cfg["serve"]["k"])
    if run.control:
        run.info["control"] = check.serve_control(
            qd[torch.from_numpy(run.rows[pick]).to(dev)], xd, idx, trees,
            cfg, run.control)
    return {"numbers": numbers, "attempted": int(run.rows.size),
            "failed": failed, "peak": peak}


def probe_ceiling(q, x, idx: dict, gt: np.ndarray, k: int,
                  probes=(16, 64, 256)) -> dict:
    """Recall@k of an exact scan over each query's ``n`` nearest clusters
    (no pruning), for each ``n`` of ``probes``: the most any plan of that
    many probes could reach on this index."""
    out = {}
    for n in probes:
        n = min(n, idx["centroids"].shape[0])
        cids = torch.topk(reference.sq_dists(q, idx["centroids"]), n, dim=1,
                          largest=False).indices
        ids = reference.exact_topk(q, x, idx["posting_ids"], cids,
                                   torch.full((q.shape[0],), n,
                                              device=q.device), k)
        hit = (torch.from_numpy(gt).to(q.device)[:, :, None]
               == ids[:, None, :]).any(-1)
        out[n] = float(hit.double().mean())
    return out


def build_cell(run: Run, sysm, dev, tmp: str) -> dict:
    cfg, tr = run.cell.config, run.cell.traffic
    t0 = time.perf_counter()
    x, _, train = _data(run.cell, run.seed, dev)
    warm_n = int(len(x) * tr["warm_fraction"])
    marks = {"data": time.perf_counter()}
    sysm.build(x[:warm_n], cfg, os.path.join(tmp, "warm"), train, dev)
    shutil.rmtree(os.path.join(tmp, "warm"), ignore_errors=True)
    _sync(dev)
    marks["warm_build"] = time.perf_counter()
    run.setup_s = marks["warm_build"] - t0
    run.info["setup"] = _steps(t0, marks)

    k23 = sysm.K23Recorder() if run.traced else None
    prof = Profile() if run.traced else None
    if prof:
        prof.__enter__()
    w0 = time.perf_counter()
    kept = []
    try:
        while not run.builds or run.builds[-1]["end"] - w0 < run.seconds:
            wd = os.path.join(tmp, f"build{len(run.builds)}")
            b0 = time.perf_counter()
            index, llsp, report = sysm.build(x, cfg, wd, train, dev)
            _sync(dev)
            run.builds.append({"start": b0, "end": time.perf_counter(),
                               "n": len(x), "report": report})
            kept.append(({k: v.cpu() for k, v in
                          sysm.index_arrays(index).items()},
                         sysm.llsp_trees(llsp)))
            del index, llsp
            shutil.rmtree(wd, ignore_errors=True)
    finally:
        if k23:
            k23.close()
    if prof:
        prof.__exit__(None, None, None)
    run.window = (w0, run.builds[-1]["end"])
    if k23:
        run.k23 = k23.calls
    if prof:
        run.trace = prof.result(run.window)
    peak = _memory_peak(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    reference.f32_products()
    xd = torch.from_numpy(x).to(dev)
    td = torch.from_numpy(train).to(dev)
    worst: dict = {}
    for idx, trees in kept:
        nums = check.build_numbers(
            xd, {k: v.to(dev) for k, v in idx.items()}, cfg, _to(trees, dev),
            td)
        worst = {k: max(v, worst.get(k, v)) for k, v in nums.items()}
    if run.control:
        idx, trees = kept[-1]
        run.info["control"] = check.build_control(
            xd, {k: v.to(dev) for k, v in idx.items()}, cfg,
            _to(trees, dev), td)
    return {"numbers": worst, "attempted": len(run.builds), "failed": 0,
            "peak": peak}


def _to(tree, dev):
    """A nest of dicts of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def index_digest(cell: Cell, sysm) -> str:
    """What a kept index was built from: the configuration, the data
    generator, :mod:`system` and the program's sources."""
    h = hashlib.sha256(json.dumps(cell.config, sort_keys=True).encode())
    for f in ("datagen.py", "system.py"):
        h.update((HERE / f).read_bytes())
    h.update(sysm.source_digest().encode())
    return h.hexdigest()[:16]


KINDS = {"closed": serve_cell, "open": serve_cell, "build": build_cell}


def run_cell(cell: Cell, metrics: list[dict], seed: int, seconds: float,
             traced: bool, device: str = "cuda",
             control: Optional[str] = None,
             extra_metrics: tuple = (), cache: Optional[str] = None) -> dict:
    """Run ``cell`` once; returns the result line's fields, the numbers
    compared beside their limits (``check``) and the :class:`Run`.
    ``extra_metrics`` are read for the log only; ``cache`` keeps a serving
    cell's built index."""
    from . import system as sysm

    dev = sysm.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = Run(cell, seed, seconds, traced, control,
              None if cache is None else str(cache))
    tmp = tempfile.mkdtemp(prefix="anns_bench-")
    try:
        out = KINDS[cell.traffic["kind"]](run, sysm, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok, shown = check.verdict(out["numbers"], cell.limits)
    run.info["numbers"] = out["numbers"]
    values = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # the cell's other metrics too, for the log on standard error
    run.info["readings"] = {
        m["name"]: v for m in extra_metrics
        if (v := reader(m["name"])(run)) is not None}
    return {"correct": bool(ok), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": values,
            "peak": out["peak"], "run": run, "check": shown}
