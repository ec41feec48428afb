"""B2's by-cluster design on the CPU: its inverted plan
(``plan_cluster_probes``, plain torch ops) and the design rule
(``b2_design``).  The plan is held against loops over the probe table and
against ``plan_tile_probes``' slot order; then the design's partial top-k2
a (query, slot) and its merge rule, written out here in torch, against the
plain version of B2.  The CUDA kernels are held against the plain version
in test_torch_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (  # noqa: E402,F401
    NAN_WHERE, assert_candidates_match, f32_case, plant_nan, torch_threads,
)
from repro_torch.core.distance import INF  # noqa: E402
from repro_torch.kernels import ivf_scan as tscan  # noqa: E402

PLAN_CASES = [  # (C, B, P, masked, dup, seed)
    (16, 8, 4, 0.2, False, 0),
    (32, 6, 8, 0.3, True, 1),           # a cluster probed twice by a query
    (5, 40, 6, 0.1, True, 2),           # many queries a cluster: > 32
    (300, 33, 16, 0.5, False, 3),
    (7, 3, 1, 0.0, False, 4),
]


def _probes(c, b, p, masked, dup, seed):
    """A probe table with duplicates, masked probes, negative ids and ids at
    or past R (clamped to R - 1, as plan_tile_probes clamps them)."""
    rng = np.random.default_rng(seed)
    cids = rng.integers(-1, c + 2, size=(b, p)).astype(np.int32)
    if dup and p > 1:
        cids[:, 1] = cids[:, 0]
    mask = rng.random((b, p)) >= masked
    return torch.from_numpy(cids), torch.from_numpy(mask)


def _live_pairs(cids, mask, c):
    """{query: ascending distinct clusters} by loops over the table."""
    out = {}
    for q in range(cids.shape[0]):
        out[q] = sorted({min(int(x), c - 1)
                         for x, m in zip(cids[q].tolist(), mask[q].tolist())
                         if m and x >= 0})
    return out


@pytest.mark.parametrize("case", PLAN_CASES)
def test_cluster_plan_holds_each_live_pair_once_with_its_slot(case):
    """Each live (query, cluster) pair appears once (a pair probed twice is
    scanned once), masked and negative probes are absent, the pairs are
    sorted by (cluster, query), and each pair's slot is its rank in the
    query's ascending-cluster order, the order plan_tile_probes gives."""
    c, b, p, masked, dup, seed = case
    cids, mask = _probes(c, b, p, masked, dup, seed)
    plan = tscan.plan_cluster_probes(cids, mask, c)
    want = _live_pairs(cids, mask, c)
    n_live = sum(len(v) for v in want.values())
    pc, pq, ps = (t.tolist() for t in (plan.pair_c, plan.pair_q,
                                       plan.pair_slot))
    assert len(pc) == b * p
    assert all(x == -1 for x in pc[n_live:])
    got = list(zip(pc[:n_live], pq[:n_live]))
    assert got == sorted((cl, q) for q, cls in want.items() for cl in cls)
    for (cl, q), s in zip(got, ps[:n_live]):
        assert want[q][s] == cl
    assert plan.n_slots.tolist() == [len(want[q]) for q in range(b)]
    # the slot order of the tile plan at one query a tile
    tile_cids, qsel = tscan.plan_tile_probes(cids, mask, 1, c)
    for q in range(b):
        live = qsel[q, :, 0] != 0
        assert tile_cids[q][live].tolist() == want[q]


@pytest.mark.parametrize("group", [1, 3, 32])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_cluster_plan_items_cover_each_run_in_groups(case, group):
    """The work items cut each cluster's run of pairs into groups of at most
    ``group``, every live pair in exactly one item; their count fits the
    grid the host sizes without reading the plan, and the entries past it
    are -1."""
    c, b, p, masked, dup, seed = case
    cids, mask = _probes(c, b, p, masked, dup, seed)
    plan = tscan.plan_cluster_probes(cids, mask, c, group=group)
    n_grid = tscan.cluster_grid(b, p, c, group)
    assert plan.items.shape == (n_grid,) and plan.items.dtype == torch.int32
    n_items = int(plan.n_items[0])
    items = plan.items.tolist()
    assert n_items <= n_grid and all(x == -1 for x in items[n_items:])
    pc = plan.pair_c.tolist()
    covered = []
    for k, start in enumerate(items[:n_items]):
        end = items[k + 1] if k + 1 < n_items else None
        run = [i for i in range(start, len(pc)) if pc[i] == pc[start]]
        size = min(group, len(run))
        assert pc[start] >= 0 and 1 <= size <= group
        assert start == 0 or pc[start - 1] != pc[start] \
            or items[k - 1] == start - group
        if end is not None:
            assert end == start + size
        covered += list(range(start, start + size))
    n_live = sum(x >= 0 for x in pc)
    assert covered == list(range(n_live))


def test_cluster_plan_of_an_empty_or_dead_batch():
    """A batch whose every probe is masked or negative has no pair, no item
    and no slot."""
    cids = torch.tensor([[3, -1], [0, 2]], dtype=torch.int32)
    mask = torch.tensor([[False, True], [False, False]])
    plan = tscan.plan_cluster_probes(cids, mask, 4)
    assert plan.pair_c.tolist() == [-1] * 4
    assert int(plan.n_items[0]) == 0 and plan.n_slots.tolist() == [0, 0]
    assert plan.items.tolist() == [-1] * tscan.cluster_grid(2, 2, 4)


def test_b2_design_is_a_function_of_shapes():
    """The design follows from (B, P, R, L, D, k2) alone: the GIST bulk
    batch goes by cluster; chip_smoke's serving batch by tile, on the whole
    index and on its packed union (B*P/R 1); the threshold on B*P/R falls
    as D widens; a small batch stays by tile at any B*P/R; shapes the
    by-cluster design does not take (P > 256, k2 > 32) go by tile; the same
    shapes always give the same design."""
    gist = (4096, 256, 29_000, 128, 960, 24)
    assert tscan.b2_design(*gist) == "by_cluster"
    assert tscan.b2_design(32, 16, 9_000, 128, 128, 24) == "by_tile"
    assert tscan.b2_design(32, 16, 512, 128, 128, 24) == "by_tile"
    r = 4096
    for d in (128, 960):
        edge = r * tscan.tile_rows(128, d) \
            // (16 * tscan.BY_CLUSTER_ROWS_PER_PROBE)
        assert tscan.b2_design(edge, 16, r, 128, d, 24) == "by_cluster"
        assert tscan.b2_design(edge - 1, 16, r, 128, d, 24) == "by_tile"
    # 128 queries over a 512-cluster union: B*P/R 4, too few dots
    assert 128 * 16 * 128 * 128 < tscan.BY_CLUSTER_MIN_MACS
    assert tscan.b2_design(128, 16, 512, 128, 128, 24) == "by_tile"
    assert tscan.b2_design(1024, 16, 512, 128, 128, 24) == "by_cluster"
    assert tscan.tile_rows(128, 128) == 64 and tscan.tile_rows(128, 960) == 8
    assert tscan.b2_design(4096, 257, 29_000, 128, 960, 24) == "by_tile"
    assert tscan.b2_design(4096, 256, 29_000, 128, 960, 33) == "by_tile"
    assert tscan.b2_design(0, 256, 29_000, 128, 960, 24) == "by_tile"
    for shape in (gist, (512, 256, 2_000, 128, 960, 24)):
        assert len({tscan.b2_design(*shape) for _ in range(3)}) == 1


def _by_cluster_emulated(post, ids, cids, mask, queries, k2):
    """The by-cluster design's function written out in torch: per live
    (query, slot) pair the partial top-k2 of the cluster's rows (unique by
    id, ascending, padded) and whether a live row gave a NaN; per query the
    partials after its last NaN slot merged in (distance, slot, rank) order,
    each id's first entry kept (extract_topk over the partials laid out
    slot by slot)."""
    r_count, l, _ = post.shape
    plan = tscan.plan_cluster_probes(cids, mask, r_count)
    b = queries.shape[0]
    p = cids.shape[1]
    part_d = torch.full((b, p, k2), INF)
    part_i = torch.full((b, p, k2), -1, dtype=torch.int32)
    part_nan = torch.zeros((b, p), dtype=torch.bool)
    n_live = int((plan.pair_c >= 0).sum())
    for c, q, s in zip(plan.pair_c[:n_live].tolist(),
                       plan.pair_q[:n_live].tolist(),
                       plan.pair_slot[:n_live].tolist()):
        qv = queries[q]
        d = torch.clamp_min(qv @ qv - 2.0 * post[c] @ qv
                            + torch.sum(post[c] * post[c], dim=1), 0.0)
        live = ids[c] >= 0
        part_nan[q, s] = bool((live & torch.isnan(d)).any())
        d = torch.where(live & ~torch.isnan(d), d, INF)
        pd, pi = tscan.extract_topk(d[None], ids[c][None], k2)
        part_d[q, s], part_i[q, s] = pd[0], pi[0]
    out_d = torch.full((b, k2), INF)
    out_i = torch.full((b, k2), -1, dtype=torch.int32)
    for q in range(b):
        n = int(plan.n_slots[q])
        wiped = torch.nonzero(part_nan[q, :n]).flatten().tolist()
        c0 = wiped[-1] + 1 if wiped else 0
        if c0 < n:
            od, oi = tscan.extract_topk(part_d[q, c0:n].reshape(1, -1),
                                        part_i[q, c0:n].reshape(1, -1), k2)
            out_d[q], out_i[q] = od[0], oi[0]
    return out_d, out_i


F32_CASES = [  # (C, L, D, B, P, dead, masked, dup, nan_dead, k2)
    (16, 8, 16, 8, 4, 0.0, 0.2, False, False, 10),
    (32, 16, 32, 6, 8, 0.3, 0.3, True, True, 10),     # dup probes, NaN dead
    (9, 16, 24, 5, 3, 0.5, 0.5, False, False, 40),    # k2 > live candidates
    (6, 32, 8, 40, 5, 0.1, 0.1, False, False, 24),    # > 32 queries a cluster
]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", F32_CASES)
def test_by_cluster_partials_and_merge_give_the_plain_b2(case):
    c, l, d, b, p, dead, masked, dup, nan_dead, k2 = case
    arrays = _t(*f32_case(c, l, d, b, p, seed=c + b, dead=dead,
                          masked=masked, dup=dup, nan_dead=nan_dead))
    gd, gi = _by_cluster_emulated(*arrays, k2=k2)
    wd, wi = tscan.ivf_scan_topk_plain(*arrays, k2=k2)
    assert_candidates_match(gd, gi, wd, wi, tol=1e-4)


@pytest.mark.parametrize("where", NAN_WHERE)
def test_by_cluster_merge_follows_the_reference_on_a_nan_distance(where):
    """A NaN distance of a live row flags its (query, slot) partial, and the
    merge drops every partial at or before the last flagged slot: the plain
    version's (the reference's) wipe."""
    arrays = f32_case(40, 32, 16, 16, 8, seed=42, dead=0.1, masked=0.1)
    post, ids, cids, mask, _ = arrays
    plant_nan(post, ids, cids, mask, where, q=1)
    arrays = _t(*arrays)
    gd, gi = _by_cluster_emulated(*arrays, k2=24)
    wd, wi = tscan.ivf_scan_topk_plain(*arrays, k2=24)
    assert not torch.isnan(gd).any()
    assert_candidates_match(gd, gi, wd, wi, tol=1e-4)
