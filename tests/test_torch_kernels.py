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
    assert_candidates_match, grid_points, q8_case, torch_threads,
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
    assert LAUNCHES.snapshot() == before          # plain versions launch none
    with pytest.raises(NotImplementedError, match="pairwise_l2"):
        tops.kmeans_assign(*_t(x, c))


def test_cuda_wrappers_refuse_cpu_tensors():
    arrays = _t(*q8_case(16, 8, 16, 4, 4, seed=6))
    with pytest.raises(ValueError, match="needs CUDA"):
        tq8.ivf_scan_q8_topk_cuda(*arrays, k2=8)
    x, c = _t(*grid_points(10, 2, 3, seed=2))
    with pytest.raises(ValueError, match="needs CUDA"):
        tassign.kmeans_assign_update_cuda(x, c)
    with pytest.raises(ValueError, match="needs CUDA"):
        tmstep.kmeans_mstep_cuda(c, torch.ones(2), c)
