"""The plain reference against brute force at a tiny size."""
from __future__ import annotations

import conftest  # noqa: F401  (paths)
import pytest
import torch

from anns_bench import datagen
from anns_bench import reference as ref

GEN = {"data_seed": 0, "modes": 3, "intrinsic_dim": 6, "center_scale": 0.4,
       "noise": 0.05, "query_shift": 0.3}


@pytest.fixture(scope="module")
def index():
    x = datagen.corpus(1200, 24, GEN, 0, "cpu")
    q = datagen.queries(64, 24, GEN, 1, "cpu")
    g = torch.Generator().manual_seed(0)
    cents = x[torch.randperm(1200, generator=g)[:30]].clone()
    assign = ref.closure(x, cents, eps=0.2, max_replicas=3)
    pids = ref.posting_ids(assign, 30, 160)
    return x, q, cents, assign, pids


def _brute(q, x, k):
    return torch.topk(torch.cdist(q.double(), x.double()), k, largest=False,
                      dim=1).indices


def test_exact_knn_is_brute_force(index):
    x, q, *_ = index
    got = ref.exact_knn(q, x, 10, block_q=16, block_x=500)
    assert torch.equal(got, _brute(q, x, 10))


def test_scan_over_every_cluster_is_brute_force(index):
    x, q, cents, _, pids = index
    assert (pids >= 0).sum() >= x.shape[0]          # every row is held
    cids = torch.argsort(ref.sq_dists(q, cents), dim=1)
    nprobe = torch.full((q.shape[0],), 30)
    got = ref.exact_topk(q, x, pids, cids, nprobe, 10)
    assert torch.equal(torch.sort(got, 1).values,
                       torch.sort(_brute(q, x, 10), 1).values)


def test_tiered_answer_with_every_candidate_is_exact(index):
    x, q, cents, _, pids = index
    cids = torch.argsort(ref.sq_dists(q, cents), dim=1)[:, :5]
    nprobe = torch.full((q.shape[0],), 5)
    want = ref.exact_topk(q, x, pids, cids, nprobe, 10)
    quant = ref.quantize(x, cents, pids, 8)
    got, tie = ref.q8_rerank_topk(q, x, cents, pids, quant, cids, nprobe,
                                  10, 5 * 160 - 1)
    assert torch.equal(torch.sort(got, 1).values, torch.sort(want, 1).values)
    assert tie.dtype == torch.bool


def test_codes_and_scale(index):
    x, _, cents, _, pids = index
    for bits, top in ((8, 127), (4, 7)):
        codes, scale, norm2 = ref.quantize(x, cents, pids, bits)
        assert codes.abs().max() == top
        assert torch.equal(codes, torch.round(codes))
        live = pids >= 0
        r = x[pids.clamp_min(0)] - cents[:, None, :]
        err = (codes * scale[:, None, None] - r)[live].abs()
        assert err.max() <= scale.max() / 2 * 1.0001
        assert torch.allclose(norm2, scale[:, None] ** 2
                              * (codes * codes).sum(-1))


def test_closure_rule_by_a_loop(index):
    x, _, cents, assign, _ = index
    for i in range(0, 1200, 97):
        d = ((cents - x[i]) ** 2).sum(1)
        order = torch.argsort(d)[:3]
        kept = [int(order[0])]
        for j in order[1:]:
            j = int(j)
            inside = d[j] <= 1.2 ** 2 * d[order[0]]
            occl = any(((cents[m] - cents[j]) ** 2).sum() < d[j] for m in kept)
            if inside and not occl:
                kept.append(j)
        got = [int(c) for c in assign[i] if c >= 0]
        assert got == kept


def test_posting_layout_by_a_loop(index):
    _, _, _, assign, pids = index
    want = [[] for _ in range(30)]
    for col in range(assign.shape[1]):
        for v in range(assign.shape[0]):
            c = int(assign[v, col])
            if c >= 0 and len(want[c]) < 160:
                want[c].append(v)
    for c in range(30):
        row = [int(v) for v in pids[c] if v >= 0]
        assert row == want[c]
    mem = ref.membership(pids, assign.shape[0], 3)
    for v in range(0, assign.shape[0], 89):
        held = sorted(c for c in range(30) if v in want[c])
        assert mem[v].tolist() == held + [-1] * (3 - len(held))


def test_tf32_rounding():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 3 * 2 ** -11),
                      1.0])
    assert ref.tf32_round(x).tolist() == [1.0, 1 + 2 ** -9, -(1 + 2 ** -9),
                                          1.0]


def test_llsp_descent_of_constant_trees():
    t, nodes = 3, 7
    ens = {"feature": torch.full((t, nodes), -1, dtype=torch.int32),
           "threshold": torch.zeros(t, nodes),
           "value": torch.full((t, nodes), 1.0), "base": torch.tensor(0.0),
           "lr": torch.tensor(0.5)}
    stacked = {k: v[None].repeat(2, *([1] * v.dim())) if v.dim() else
               torch.stack([v, v]) for k, v in ens.items()}
    stacked["base"] = torch.tensor([0.0, 10.0])
    trees = {"router": ens, "pruners": stacked,
             "levels": torch.tensor([4, 8], dtype=torch.int32)}
    q = torch.zeros(5, 3)
    cd = torch.arange(1, 41, dtype=torch.float32).repeat(5, 1)
    # router: 0.5 * 3 = 1.5 -> level 2 rounds to even, clamped to 1;
    # pruner of level 1: 10 + 1.5 -> ceil 12, capped at 8
    got = ref.llsp_nprobe(trees, q, torch.full((5,), 10), cd, 4)
    assert got.tolist() == [8] * 5


def test_distortion_is_brute_force(index):
    x, _, cents, *_ = index
    d = torch.cdist(x.double(), cents.double()) ** 2
    assert ref.distortion(x, cents, block=500) == pytest.approx(
        float(d.min(1).values.mean()), rel=1e-5)


def test_nprobe_labels_are_the_fewest_probes_that_reach_the_target(index):
    x, q, cents, _, pids = index
    k, target, p = 10, 0.9, 12
    got = ref.nprobe_labels(q, x, cents, pids, nprobe_max=p, k=k,
                            target=target)
    order = torch.argsort(ref.sq_dists(q, cents), dim=1)[:, :p]
    for i in range(q.shape[0]):
        pool = torch.unique(pids[order[i]][pids[order[i]] >= 0])
        dd = ((x[pool] - q[i]) ** 2).sum(1)
        true = set(pool[torch.argsort(dd)[:k]].tolist())
        want = p
        for n in range(1, p + 1):
            held = set(pids[order[i, :n]].flatten().tolist())
            if len(true & held) >= 9:
                want = n
                break
        assert int(got[i]) == want, i


def test_f32_products_turns_tf32_off():
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        ref.f32_products()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        ref.f32_products()
