"""The system under test, as the benchmark deploys and drives it: the only
module of the harness that imports the program (``repro_torch``).

* :func:`build` runs ``build_index`` with the configuration's settings;
  :func:`build_kept` keeps its outcome in a directory of the checkout
  (the stage-1 centroids and stage-2 shards from which ``build_index``
  resumes, and LLSP's trees), so that a serving cell builds its index in
  the first run of a checkout only; :func:`source_digest` names the
  program's sources the directory was built from;
* :func:`deploy` wraps a built index in its serving pipeline (the q8 host
  tier with the flash re-rank, or f32 postings resident on the card) and
  warms every padded batch size the cell's batcher can release;
* :func:`engine` makes a fresh ``ServeEngine`` with the traffic's batching
  policy;
* :class:`Recorder` keeps each served batch's stamps and probe counts, the
  spans and counters the per-layer metrics read, by wrapping the
  pipeline's stage calls from the outside;
* :func:`llsp_trees` and :func:`index_arrays` hand the deployment's state
  to the reference as plain tensors.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

import repro_torch
from repro_torch.build.pipeline import BuildConfig, build_index
from repro_torch.core.distance import squared_l2_chunked, topk_smallest
from repro_torch.core.ivf import search_flat
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.llsp import LLSPConfig, LLSPParams, train_llsp
from repro_torch.core.search import SearchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.runtime import (BatchPolicy, DynamicBatcher,
                                 PrefetchPipeline, RerankConfig, ServeEngine,
                                 make_quantized_pipeline)
from repro_torch.runtime.engine import QueuePair


def device(kind: str = "cuda") -> torch.device:
    return resolve_device(kind)


def build_config(cfg: dict) -> BuildConfig:
    b = cfg["build"]
    return BuildConfig(
        max_cluster_size=b["max_cluster_size"], cluster_len=b["cluster_len"],
        coarse_per_task=b["coarse_per_task"], n_workers=b["n_workers"],
        closure_eps=b["closure_eps"], max_replicas=b["max_replicas"],
        kmeans_iters=b["kmeans_iters"], seed=b["seed"],
        llsp=LLSPConfig(levels=tuple(cfg["llsp"]["levels"]),
                        recall_target=cfg["llsp"]["recall_target"],
                        n_ratio_features=cfg["llsp"]["n_ratio"]))


def search_config(cfg: dict) -> SearchConfig:
    s = cfg["serve"]
    return SearchConfig(k=s["k"], nprobe_max=s["nprobe_max"],
                        pruning="llsp", n_ratio=cfg["llsp"]["n_ratio"],
                        use_kernel=True, fused_topk=True)


def build(x: np.ndarray, cfg: dict, workdir: str, train_q: np.ndarray,
          dev: torch.device):
    """(index, llsp, report) of one build of ``x`` on ``dev``.

    With ``llsp.train_chunk`` set, ``build_index`` builds without LLSP and
    LLSP is trained after it by :func:`train_llsp_chunked`."""
    topk = np.full(len(train_q), cfg["serve"]["k"], np.int32)
    if not cfg["llsp"].get("train_chunk"):
        return build_index(x, build_config(cfg), workdir, queries=train_q,
                           query_topk=topk, device=dev)
    index, _, report = build_index(x, build_config(cfg), workdir,
                                   device=dev)
    t0 = time.perf_counter()
    llsp = train_llsp_chunked(cfg, index, x, train_q)
    report.stage_seconds["stage3"] = time.perf_counter() - t0
    return index, llsp, report


def build_kept(x: np.ndarray, cfg: dict, keep: str, train_q: np.ndarray,
               dev: torch.device):
    """(index, llsp, report, kept) of :func:`build`, its outcome kept in
    the directory ``keep``.  The first call builds in ``keep``'s sibling
    ``.part`` directory, saves LLSP's trees beside the build's files and
    renames it to ``keep``; a later call runs ``build_index`` on ``keep``,
    which resumes from the stage-1 centroids and the stage-2 shards there
    (the postings are laid out again from ``x``), and loads the trees.
    ``kept`` tells which of the two it was."""
    trees = os.path.join(keep, "llsp.pt")
    if os.path.exists(trees):
        index, _, report = build_index(x, build_config(cfg),
                                       os.path.join(keep, "build"),
                                       device=dev)
        return index, load_llsp(trees, dev), report, True
    part = keep + ".part"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    index, llsp, report = build(x, cfg, os.path.join(part, "build"), train_q,
                                dev)
    torch.save(_llsp_state(llsp), os.path.join(part, "llsp.pt"))
    shutil.rmtree(keep, ignore_errors=True)
    os.replace(part, keep)
    return index, llsp, report, False


def _llsp_state(llsp) -> dict:
    def ens(p):
        return {f.name: getattr(p, f.name).cpu()
                for f in dataclasses.fields(p)}
    return {"router": ens(llsp.router), "pruners": ens(llsp.pruners),
            "levels": llsp.levels.cpu()}


def load_llsp(path: str, dev: torch.device):
    st = torch.load(path, map_location="cpu", weights_only=True)
    return LLSPParams(GBDTParams(**st["router"]),
                      GBDTParams(**st["pruners"]), st["levels"]).to(dev)


def source_digest() -> str:
    """A digest of the program's source files (``repro_torch``)."""
    root = Path(repro_torch.__file__).resolve().parent
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".cpp", ".h"):
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def train_llsp_chunked(cfg: dict, index, x: np.ndarray,
                       train_q: np.ndarray):
    """``build.pipeline.train_llsp_for_index`` step for step, with its
    labelling search (``search_flat`` at nprobe nmax) over
    ``llsp.train_chunk`` queries at a time: at D = 960 the whole call
    gathers (256, 256, 128, 960) floats twice, 60 GiB, more than the card
    holds beside the index.  Each query's labels are the same either way
    (the search is elementwise per query)."""
    llsp_cfg = build_config(cfg).llsp
    k, chunk = cfg["serve"]["k"], cfg["llsp"]["train_chunk"]
    dev = index.device
    q = torch.from_numpy(np.asarray(train_q, np.float32)).to(dev)
    topk = np.full(len(train_q), k, np.int64)
    nmax = min(llsp_cfg.nmax, index.n_clusters)
    cdists, cid_order = topk_smallest(
        squared_l2_chunked(q, index.centroids), nmax)
    true = np.concatenate([
        search_flat(index, q[s:s + chunk], k, nprobe=nmax)[1].cpu().numpy()
        for s in range(0, len(q), chunk)])
    params = train_llsp(llsp_cfg, np.asarray(train_q, np.float32), topk,
                        cid_order.cpu().numpy(), cdists.cpu().numpy(), true,
                        index.posting_ids.cpu().numpy(), x.shape[0],
                        seed=cfg["build"]["seed"])
    return params.to(dev)


@dataclasses.dataclass
class Deployment:
    pipeline: PrefetchPipeline
    name: str


def deploy(index, llsp, x: np.ndarray, cfg: dict, workdir: str,
           dev: torch.device) -> Deployment:
    scfg = search_config(cfg)
    tier = cfg["serve"]["tier"]
    if tier == "q8":
        pipe = make_quantized_pipeline(
            index, llsp, scfg, vectors=x, flash_path=f"{workdir}/flash.f32",
            rerank=RerankConfig(), with_flash=True, device=dev)
    elif tier == "f32_resident":
        pipe = PrefetchPipeline(index, llsp, scfg, tier=None, device=dev)
    else:
        raise ValueError(f"unknown serving tier {tier!r}")
    return Deployment(pipe, cfg["name"])


def warm(dep: Deployment, traffic: dict) -> int:
    """The pipeline's own warm-up at the traffic's batch sizes."""
    return dep.pipeline.warmup(batch_sizes=tuple(traffic["warm_sizes"]))


def engine(dep: Deployment, traffic: dict) -> ServeEngine:
    policy = BatchPolicy(max_batch=traffic["max_batch"],
                         max_wait_s=traffic["max_wait_s"],
                         shed=traffic["shed"],
                         grouping=traffic["grouping"])
    return ServeEngine({dep.name: dep.pipeline},
                       DynamicBatcher(policy, [dep.name]),
                       qp=QueuePair(sq_depth=traffic["sq_depth"]),
                       depth=traffic["depth"])


class Recorder:
    """Per-batch records of a deployment's pipeline, taken from the stage
    calls: each harvested batch's StageTimes and probe counts, and with
    ``plans`` each plan's host probe table (for the union of clusters a
    resident scan reads).  Installed on the instance, removed by
    :meth:`close`."""

    def __init__(self, dep: Deployment, plans: bool):
        self.pipe = dep.pipeline
        self.batches: list = []
        self.plans: list = []
        self._harvest, self._plan = self.pipe.harvest, self.pipe.plan

        def harvest(infl):
            res = self._harvest(infl)
            self.batches.append((res.times, res.nprobe))
            return res

        def plan(*a, **kw):
            p = self._plan(*a, **kw)
            self.plans.append((p.cids, p.pmask, p.times.size))
            return p

        self.pipe.harvest = harvest
        if plans:
            self.pipe.plan = plan

    def close(self) -> None:
        for k in ("harvest", "plan"):
            self.pipe.__dict__.pop(k, None)


class K23Recorder:
    """The sub-problem sizes of every K23 launch, from the arguments of
    ``kernels.ops.kmeans_batched`` (host tensors: reading them costs no
    device wait)."""

    def __init__(self):
        self.calls: list = []
        self._orig = kops.kmeans_batched

        def wrapped(x, pts, offs, k, init, iters, **kw):
            o = offs.numpy()
            self.calls.append((np.diff(o).tolist(), k.numpy().tolist(),
                               int(x.shape[1]), int(iters)))
            return self._orig(x, pts, offs, k, init, iters, **kw)

        kops.kmeans_batched = wrapped

    def close(self) -> None:
        kops.kmeans_batched = self._orig


def llsp_trees(llsp) -> dict:
    """The trained LLSP ensembles as plain tensors."""
    def ens(p):
        return {f: getattr(p, f) for f in
                ("feature", "threshold", "value", "base", "lr")}
    return {"router": ens(llsp.router), "pruners": ens(llsp.pruners),
            "levels": llsp.levels}


def index_arrays(index) -> dict:
    return {"centroids": index.centroids, "posting_ids": index.posting_ids,
            "postings": index.postings}

