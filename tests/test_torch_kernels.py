"""The port's three kernels (q8 fused scan, k-means assign/update, k-means
M-step): their plain torch versions against the JAX package on identical
numpy inputs (Pallas kernels in interpret mode, as the JAX tests run them)
and the dispatch rule of ``repro_torch.kernels.ops``.  The CUDA kernels
themselves are held against the plain versions in test_torch_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import (  # noqa: E402,F401
    NAN_WHERE, assert_candidates_match, grid_points, plant_nan, q8_case,
    torch_threads,
)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ivf_scan import plan_tile_probes as j_plan  # noqa: E402
from repro.kernels.kmeans_assign import \
    kmeans_assign_update as j_assign  # noqa: E402
from repro.kernels.kmeans_mstep import kmeans_mstep as j_mstep  # noqa: E402
from repro_torch.kernels import ivf_scan_q8 as tq8  # noqa: E402
from repro_torch.kernels import kmeans_assign as tassign  # noqa: E402
from repro_torch.kernels import kmeans_mstep as tmstep  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.cuda_lib import LAUNCHES  # noqa: E402
from repro_torch.kernels.ivf_scan import extract_topk, \
    plan_tile_probes  # noqa: E402

Q8_TOL = 1e-3
Q8_CASES = [  # (C, L, D, B, P, dead, masked, dup, k2)
    (16, 8, 16, 4, 4, 0.0, 0.2, False, 10),
    (32, 16, 32, 6, 8, 0.3, 0.3, True, 10),
    (9, 16, 24, 5, 3, 0.5, 0.5, False, 40),     # k2 > live candidates
    (20, 32, 64, 13, 7, 0.1, 0.0, True, 24),    # B not a tile multiple
]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", Q8_CASES)
def test_q8_plain_matches_jax_kernel_and_oracle(case):
    c, l, d, b, p, dead, masked, dup, k2 = case
    arrays = q8_case(c, l, d, b, p, seed=c + l + d, dead=dead,
                     masked=masked, dup=dup)
    gd, gi = tq8.ivf_scan_q8_topk_plain(*_t(*arrays), k2=k2)
    jd, ji = jops.ivf_scan_q8_topk(*(jnp.asarray(a) for a in arrays),
                                   k2=k2, bq=4)
    assert_candidates_match(gd, gi, jd, ji, tol=Q8_TOL)
    wd, wi = jref.ivf_scan_q8_topk_ref(*(jnp.asarray(a) for a in arrays),
                                       k2)
    assert_candidates_match(gd, gi, wd, wi, tol=Q8_TOL)
    td, ti = tref.ivf_scan_q8_topk_ref(*_t(*arrays), k2=k2)
    assert_candidates_match(gd, gi, td, ti, tol=Q8_TOL)


def test_q8_duplicate_probe_scanned_once_and_dead_slots_dropped():
    arrays = list(q8_case(8, 4, 8, 4, 4, seed=0, masked=0.0))
    arrays[5] = np.full((4, 4), 3, np.int32)          # probe cluster 3 4x
    arrays[6] = np.ones((4, 4), bool)
    arrays[6][0] = False                               # query 0 masked
    arrays[4][3] = [10, -1, 12, 13]                    # one dead slot
    gd, gi = tq8.ivf_scan_q8_topk_plain(*_t(*arrays), k2=8)
    gd, gi = gd.numpy(), gi.numpy()
    assert np.isinf(gd[0]).all() and (gi[0] == -1).all()
    for r in range(1, 4):
        valid = gi[r][gi[r] >= 0]
        assert sorted(valid.tolist()) == [10, 12, 13]
        assert np.isinf(gd[r][3:]).all()


@pytest.mark.parametrize("where", NAN_WHERE)
def test_q8_plain_follows_the_reference_on_a_nan_distance(where):
    """A NaN in a live slot's norm makes that row's distance NaN: the
    query's candidates are emptied at that slot and refilled by later
    slots only, as the reference's ``_extract_topk`` does (the Pallas
    kernel in interpret mode, tiles of 8 queries; the port plans one query
    a tile, in the same ascending cluster order)."""
    arrays = q8_case(10, 8, 8, 12, 4, seed=22, dead=0.2, masked=0.1)
    norm2, ids, cids, mask = arrays[2], arrays[4], arrays[5], arrays[6]
    c = plant_nan(norm2, ids, cids, mask, where, q=1)
    gd, gi = tq8.ivf_scan_q8_topk_plain(*_t(*arrays), k2=8)
    jd, ji = jops.ivf_scan_q8_topk(*(jnp.asarray(a) for a in arrays),
                                   k2=8, bq=8)
    assert not torch.isnan(gd).any()
    assert_candidates_match(gd, gi, jd, ji, tol=Q8_TOL)
    kept = gi.numpy()[1]
    kept = kept[kept >= 0]
    assert np.isin(kept, ids[c + 1:]).all()
    last = c == cids[1][mask[1] & (cids[1] >= 0)].max()
    assert (kept.size == 0) == last and last == (where == "last")


@pytest.mark.parametrize("b,p,bq,n,chunk", [(2, 4, 2, 8, 0), (48, 16, 8, 30, 0),
                                            (48, 16, 8, 30, 1),
                                            (48, 16, 8, 30, 5),
                                            (33, 5, 1, 12, 0)])
def test_plan_tile_probes_bit_identical(b, p, bq, n, chunk):
    rng = np.random.default_rng(b * p + n)
    cids = rng.integers(-1, n + 2, size=(b, p)).astype(np.int32)
    mask = rng.random((b, p)) < 0.7
    jt, jq = j_plan(jnp.asarray(cids), jnp.asarray(mask), bq, n,
                    tile_chunk=chunk)
    tt, tq = plan_tile_probes(torch.from_numpy(cids), torch.from_numpy(mask),
                              bq, n, tile_chunk=chunk)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tt.dtype == torch.int32 and tq.dtype == torch.int32


@pytest.mark.parametrize("p", [1, 2, 7, 16, 33, 64])
@pytest.mark.parametrize("kind", ["mixed", "duplicates", "all_masked",
                                  "negative"])
def test_query_plan_plain_matches_plan_tile_probes_one_query_a_tile(kind, p):
    """The plan K1 builds in each block (its plain version) is the plan of
    the JAX package's and the port's ``plan_tile_probes`` at one query a
    tile: sorted, deduplicated, masked and negative probes dead and last,
    out-of-range ids clamped."""
    rng = np.random.default_rng(100 * p + len(kind))
    b, n = 11, 24
    cids = rng.integers(-2, n + 3, size=(b, p)).astype(np.int32)
    mask = rng.random((b, p)) < 0.8
    if kind == "duplicates":
        cids = rng.integers(0, 4, size=(b, p)).astype(np.int32)
        cids[:, -1] = cids[:, 0]
    elif kind == "all_masked":
        mask[:] = False
    elif kind == "negative":
        cids[rng.random((b, p)) < 0.5] = -1
        mask[:] = True
    mask[0] = False                          # one fully masked query always
    tc, tm = torch.from_numpy(cids), torch.from_numpy(mask)
    got_c, got_q = tq8.query_plan_plain(tc, tm, n)
    jt, jq = j_plan(jnp.asarray(cids), jnp.asarray(mask), 1, n)
    pt, pq = plan_tile_probes(tc, tm, 1, n)
    assert got_c.dtype == torch.int32 and got_q.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(jq).reshape(b, p))
    np.testing.assert_array_equal(got_c.numpy(), pt.numpy())
    np.testing.assert_array_equal(got_q.numpy(), pq.reshape(b, p).numpy())
    live = mask & (cids >= 0)
    for r in range(b):
        want = np.unique(np.clip(cids[r][live[r]], 0, n - 1))
        np.testing.assert_array_equal(got_c.numpy()[r][got_q.numpy()[r] != 0],
                                      want)


def test_extract_topk_merge_rule_matches_jax():
    from repro.kernels.ivf_scan import _extract_topk

    rng = np.random.default_rng(3)
    d = rng.integers(0, 6, size=(5, 40)).astype(np.float32)  # many ties
    d[rng.random(d.shape) < 0.2] = np.inf
    ids = rng.integers(-1, 12, size=(5, 40)).astype(np.int32)
    d[ids < 0] = np.inf
    jd, ji = _extract_topk(jnp.asarray(d), jnp.asarray(ids), 9)
    td, ti = extract_topk(torch.from_numpy(d), torch.from_numpy(ids), 9)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n,k,d", [(700, 9, 6), (64, 40, 3), (1025, 5, 16)])
def test_kmeans_assign_plain_bit_equal_to_jax(n, k, d):
    x, c = grid_points(n, k, d, seed=n + k)
    ta, tmd, ts, tc = tassign.kmeans_assign_update_plain(*_t(x, c))
    ja, jmd, js, jc = j_assign(jnp.asarray(x), jnp.asarray(c), bn=256,
                               interpret=True)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tmd.numpy(), np.asarray(jmd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int32))
    oa, omd, osum, ocnt = jops.kmeans_assign_update(jnp.asarray(x),
                                                    jnp.asarray(c))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(oa))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(ocnt))
    assert not (ta.numpy() == k // 2).any()           # first index wins ties
    ra, _, rs, rc = tref.kmeans_assign_update_ref(*_t(x, c))
    np.testing.assert_array_equal(ra.numpy(), ta.numpy())
    np.testing.assert_array_equal(rs.numpy(), ts.numpy())


@pytest.mark.parametrize("nan_at", ["row", "centroid", "both"])
def test_kmeans_assign_plain_keeps_a_nan_distance_as_jax(nan_at):
    """A NaN distance wins the argmin, the first NaN first (jnp.argmin and
    torch.argmin), and stays NaN in min_dist (jnp.maximum's clamp), on the
    Pallas kernel in interpret mode and on the reference's ops path alike.
    Sums: the reference folds them with a one-hot product, where 0 x NaN
    spreads a NaN coordinate into every other cluster's column; the port
    follows it, NaN for NaN and bit for bit elsewhere."""
    x, c = grid_points(300, 7, 5, seed=3)
    if nan_at in ("row", "both"):
        x[17, 2] = np.nan
    if nan_at in ("centroid", "both"):
        c[4, 1] = np.nan
    ta, tmd, ts, tc = tassign.kmeans_assign_update_plain(*_t(x, c))
    ja, jmd, js, jc = j_assign(jnp.asarray(x), jnp.asarray(c), bn=256,
                               interpret=True)
    oa, omd, osum, ocnt = jops.kmeans_assign_update(jnp.asarray(x),
                                                    jnp.asarray(c))
    for wa, wmd, ws, wc in ((ja, jmd, js, jc), (oa, omd, osum, ocnt)):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(tmd.numpy(), np.asarray(wmd))
        np.testing.assert_array_equal(tc.numpy(),
                                      np.asarray(wc).astype(np.int32))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    assert np.isnan(tmd.numpy()).any()
    if nan_at == "row":
        assert ta[17] == 0                 # every distance NaN: index 0
    else:
        assert (ta.numpy() == 4).sum() >= 299   # the NaN centroid wins


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf", "inf_and_-inf",
                                  "two_points"])
def test_kmeans_assign_plain_sums_follow_the_one_hot_rule(kind):
    """A non-finite coordinate in column d of a point outside cluster k
    makes sums[k, d] NaN (the reference's onehot(a)^T @ x: 0 x inf and
    0 x NaN are NaN); every other sum is cluster k's ordered sum.  Against
    the Pallas kernel in interpret mode and the reference's ops path, NaN
    for NaN and bit for bit elsewhere."""
    x, c = grid_points(300, 7, 5, seed=4)
    bad = {"nan": [(17, np.nan)], "inf": [(17, np.inf)],
           "-inf": [(17, -np.inf)],
           "inf_and_-inf": [(17, np.inf), (18, -np.inf)],
           "two_points": [(17, np.nan), (250, np.inf)]}[kind]
    for row, v in bad:
        x[row, 2] = v
    ta, tmd, ts, tc = tassign.kmeans_assign_update_plain(*_t(x, c))
    ja, _, js, jc = j_assign(jnp.asarray(x), jnp.asarray(c), bn=128,
                             interpret=True)
    oa, _, osum, _ = jops.kmeans_assign_update(jnp.asarray(x),
                                               jnp.asarray(c))
    for wa, ws in ((ja, js), (oa, osum)):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int32))
    ts = ts.numpy()
    own = {int(ta[row]) for row, _ in bad}
    others = [k for k in range(7) if k not in own]
    assert np.isnan(ts[others, 2]).all()
    assert np.isfinite(np.delete(ts, 2, axis=1)).all()


@pytest.mark.parametrize("k,d,n_empty,int_counts", [(8, 16, 3, False),
                                                    (130, 7, 40, True),
                                                    (1, 4, 1, False)])
def test_kmeans_mstep_plain_bit_equal_to_jax(k, d, n_empty, int_counts):
    rng = np.random.default_rng(k + d)
    sums = (rng.integers(-64, 64, size=(k, d)) / 8.0).astype(np.float32)
    counts = rng.integers(1, 9, size=k)
    counts[rng.choice(k, size=n_empty, replace=False)] = 0
    counts = counts.astype(np.int32 if int_counts else np.float32)
    reseed = (rng.integers(-64, 64, size=(k, d)) / 8.0).astype(np.float32)
    got = tmstep.kmeans_mstep_plain(*_t(sums, counts, reseed)).numpy()
    want = np.asarray(j_mstep(jnp.asarray(sums), jnp.asarray(counts),
                              jnp.asarray(reseed), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tref.kmeans_mstep_ref(*_t(sums, counts, reseed)).numpy())


@pytest.mark.parametrize("k,d,empty,int_counts,big", [
    (8, 128, "some", True, False),
    (8, 128, "none", False, False),
    (8, 128, "all", True, False),
    (1, 4, "all", False, False),
    (1, 9, "none", True, False),
    (2048, 16, "some", True, False),
    (2048, 16, "some", False, True),
    (300, 5, "some", True, True),
])
def test_kmeans_mstep_plain_edges_bit_equal_to_jax(k, d, empty, int_counts,
                                                   big):
    """K3's plain version against the Pallas kernel in interpret mode:
    none, some or all clusters empty (K' = K > #empty), K 1 and 2,048,
    int32 and f32 counts, and int32 counts above 2^24, where the f32 cast
    rounds to nearest (both take counts.astype(f32))."""
    rng = np.random.default_rng(k * 7 + d)
    sums = rng.normal(size=(k, d)).astype(np.float32)
    lo, hi = ((1 << 24) + 1, 1 << 30) if big else (1, 50)
    counts = rng.integers(lo, hi, size=k)
    n_empty = {"none": 0, "some": max(1, k // 5), "all": k}[empty]
    counts[rng.choice(k, size=n_empty, replace=False)] = 0
    counts = counts.astype(np.int32 if int_counts else np.float32)
    if big and int_counts:
        assert (counts.astype(np.float32).astype(np.int64)
                != counts.astype(np.int64)).any()     # rounding happens
    reseed = rng.normal(size=(k, d)).astype(np.float32)
    got = tmstep.kmeans_mstep_plain(*_t(sums, counts, reseed)).numpy()
    want = np.asarray(j_mstep(jnp.asarray(sums), jnp.asarray(counts),
                              jnp.asarray(reseed), interpret=True))
    np.testing.assert_array_equal(got, want)
    empty_rows = counts.astype(np.float32) <= 0
    np.testing.assert_array_equal(got[empty_rows], reseed[:n_empty])


def test_kmeans_mstep_plain_takes_exactly_one_reseed_row_an_empty():
    """K' = #empty with a non-empty cluster after the last empty one: the
    plain version gathers only the empty clusters' rows (the JAX kernel
    takes K' = K, so this edge is the port's own contract)."""
    sums = np.arange(12, dtype=np.float32).reshape(4, 3)
    counts = np.asarray([0, 2, 0, 4], np.int32)
    reseed = np.asarray([[9, 9, 9], [7, 7, 7]], np.float32)
    got = tmstep.kmeans_mstep_plain(*_t(sums, counts, reseed)).numpy()
    want = np.stack([reseed[0], sums[1] / 2, reseed[1], sums[3] / 4])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="at least one row"):
        tmstep.kmeans_mstep_plain(*_t(sums, np.ones(4, np.int32),
                                      np.zeros((0, 3), np.float32)))


@pytest.mark.parametrize("d,addrs,want", [
    (128, (0, 512, 1024), "vec16"),
    (4, (16, 32, 48), "vec16"),
    (128, (4, 512, 1024), "vec4"),        # sums at a 4-byte offset
    (128, (0, 520, 1024), "vec4"),        # reseed at an 8-byte offset
    (128, (0, 512, 1036), "vec4"),        # output at a 12-byte offset
    (130, (0, 512, 1024), "vec4"),        # D % 4 != 0
    (3, (0, 0, 0), "vec4"),
])
def test_kmeans_mstep_variant_is_a_function_of_d_and_addresses(d, addrs,
                                                               want):
    assert tmstep.kmeans_mstep_variant(d, *addrs) == want
    assert tmstep.kmeans_mstep_variant(d, *addrs) == \
        tmstep.kmeans_mstep_variant(d, *addrs)


@pytest.mark.parametrize("k,d", [(1, 128), (2, 128), (8, 128), (2048, 128),
                                 (14000, 128), (20614, 128), (20614, 3),
                                 (65, 3), (37, 1)])
def test_kmeans_mstep_grid_covers_k_with_flag_reads_under_the_output(k, d):
    """Every row in exactly one block, and the flags the blocks read
    before their first rows (block b reads b * rows) stay under the
    output's bytes."""
    blocks, rows = tmstep.kmeans_mstep_grid(k, d)
    assert blocks >= 1 and rows >= 1
    assert (blocks - 1) * rows < k <= blocks * rows
    flag_bytes = 4 * rows * blocks * (blocks - 1) // 2
    assert flag_bytes < 4 * k * d
    assert blocks <= tmstep.MAX_BLOCKS


def test_ops_dispatch_cpu_to_plain_versions_without_counting():
    arrays = q8_case(16, 8, 16, 4, 4, seed=5)
    x, c = grid_points(100, 4, 3, seed=1)
    before = LAUNCHES.snapshot()
    gd, gi = tops.ivf_scan_q8_topk(*_t(*arrays), k2=8)
    pd, pi = tq8.ivf_scan_q8_topk_plain(*_t(*arrays), k2=8)
    assert torch.equal(gd, pd) and torch.equal(gi, pi)
    a, _, s, n = tops.kmeans_assign_update(*_t(x, c))
    pa, _, ps, pn = tassign.kmeans_assign_update_plain(*_t(x, c))
    assert torch.equal(a, pa) and torch.equal(s, ps) and torch.equal(n, pn)
    m = tops.kmeans_mstep(s, n, torch.zeros_like(s))
    assert torch.equal(m, tmstep.kmeans_mstep_plain(s, n, torch.zeros_like(s)))
    ta, tmd = tops.kmeans_assign(*_t(x, c), chunk=32)   # the unfused E-step
    ja, jmd = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c), chunk=32)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tmd.numpy(), np.asarray(jmd))
    assert ta.dtype == torch.int32
    assert LAUNCHES.snapshot() == before          # plain versions launch none


def test_cuda_wrappers_refuse_cpu_tensors():
    arrays = _t(*q8_case(16, 8, 16, 4, 4, seed=6))
    with pytest.raises(ValueError, match="needs CUDA"):
        tq8.ivf_scan_q8_topk_cuda(*arrays, k2=8)
    x, c = _t(*grid_points(10, 2, 3, seed=2))
    with pytest.raises(ValueError, match="needs CUDA"):
        tassign.kmeans_assign_update_cuda(x, c)
    with pytest.raises(ValueError, match="needs CUDA"):
        tmstep.kmeans_mstep_cuda(c, torch.ones(2), c)
    from repro_torch.kernels import kmeans_batched as tbatched

    idx = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA"):
        tbatched.kmeans_batched_cuda(x, idx, torch.tensor([0, 10]).int(),
                                     torch.ones(1, dtype=torch.int32),
                                     torch.zeros((1, 16), dtype=torch.int32),
                                     3)
