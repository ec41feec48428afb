"""Each cell's control, the reference in the next lower precision put in
the program's place, is judged not correct by the cell's own limits, at a
size a test run holds.  (On the card the controls are read at the cells'
own sizes: ``run.py --control``.)"""
from __future__ import annotations

import json

import torch
from conftest import ROOT, tiny_cell

from anns_bench import check, datagen, harness
from anns_bench import reference as ref


def _limits(workload):
    return json.loads((ROOT / "anns_bench" / "limits" /
                       f"{workload}.json").read_text())


def test_int4_codes_fail_the_tiered_cell():
    cell = tiny_cell("sift1m-q8.bulk")
    res = harness.run_cell(cell, [], 2 ** 33 + 9, 1.0, False, device="cpu",
                           control="int4")
    assert res["correct"]
    ctrl = res["run"].info["control"]
    ok, shown = check.verdict({**ctrl, "failed": 0.0}, _limits(cell.name))
    assert not ok, shown


def test_tf32_fails_the_resident_cell():
    """GIST's widths over 20,000 rows in two modes (a mode as dense as the
    cell's), 2,048 queries at 48 probes: TF32's error in the scan and in
    the centroid ranking loses neighbours that float32 keeps."""
    cfg = json.loads((ROOT / "anns_bench" / "configs" /
                      "gist1m-f32res.json").read_text())
    gen = dict(cfg["assumed"]["generator"], modes=2)
    n, dim, c = 20000, cfg["dataset"]["dim"], 20000 // 48
    x = datagen.corpus(n, dim, gen, 0, "cpu")
    q = datagen.queries(2048, dim, gen, 1, "cpu")
    cents = x[torch.randperm(n, generator=torch.Generator().manual_seed(0))
              [:c]].clone()
    for _ in range(4):
        a = ref.sq_dists(x, cents).argmin(1)
        s = torch.zeros_like(cents).index_add_(0, a, x)
        k = torch.bincount(a, minlength=c).float()
        cents[k > 0] = s[k > 0] / k[k > 0, None]
    pids = ref.posting_ids(ref.closure(x, cents, eps=0.2, max_replicas=4),
                           c, 128)
    # LLSP trees that send every query to 48 probes
    leaf = {"feature": torch.full((1, 63), -1, dtype=torch.int32),
            "threshold": torch.zeros(1, 63), "value": torch.zeros(1, 63)}
    trees = {"router": {**leaf, "base": torch.tensor(0.0),
                        "lr": torch.tensor(1.0)},
             "pruners": {k: v[None] for k, v in leaf.items()}
             | {"base": torch.tensor([48.0]), "lr": torch.tensor([1.0])},
             "levels": torch.tensor([48], dtype=torch.int32)}
    cfg["serve"]["nprobe_max"] = 48
    idx = {"centroids": cents, "posting_ids": pids}
    ctrl = check.serve_control(q, x, idx, trees, cfg, "tf32")
    ok, shown = check.verdict({**ctrl, "failed": 0.0},
                              _limits("gist1m-f32res.bulk"))
    assert not ok, shown


def test_tf32_closure_fails_the_build_cell():
    cell = tiny_cell("sift1m-q8.build", n=20000)
    res = harness.run_cell(cell, [], 2 ** 33 + 11, 0.5, False, device="cpu",
                           control="tf32")
    assert res["correct"], res["check"]
    ok, shown = check.verdict(res["run"].info["control"], cell.limits)
    assert not ok, shown
