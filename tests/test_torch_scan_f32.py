"""The port's f32 scan and distance kernels on the CPU: the plain versions
of B2 ``ivf_scan_topk``, B6a ``ivf_scan`` and B5 ``pairwise_l2`` against the
JAX package on identical numpy inputs (its oracles, and its Pallas kernels
in interpret mode at tiny shapes), and the dispatch rule of
``repro_torch.kernels.ops`` for them.  The CUDA kernels themselves are held
against the plain versions in test_torch_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import (  # noqa: E402,F401
    NAN_WHERE, assert_candidates_match, f32_case, grid_points, plant_nan,
    torch_threads,
)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ivf_scan as tscan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pairwise_l2 as tpw  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.cuda_lib import LAUNCHES  # noqa: E402

F32_TOL = 1e-4
F32_CASES = [  # (C, L, D, B, P, dead, masked, dup, nan_dead, k2)
    (16, 8, 16, 8, 4, 0.0, 0.2, False, False, 10),
    (32, 16, 32, 6, 8, 0.3, 0.3, True, False, 10),     # ragged B, dup probes
    (9, 16, 24, 5, 3, 0.5, 0.5, False, False, 40),     # k2 > live candidates
    (20, 32, 64, 13, 7, 0.1, 0.0, True, False, 24),    # B not a tile multiple
    (12, 8, 8, 16, 5, 0.4, 0.1, False, True, 16),      # NaN payload, dead rows
]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_topk_plain_matches_jax_oracle(case):
    c, l, d, b, p, dead, masked, dup, nan_dead, k2 = case
    arrays = f32_case(c, l, d, b, p, seed=c + l + d, dead=dead,
                      masked=masked, dup=dup, nan_dead=nan_dead)
    gd, gi = tscan.ivf_scan_topk_plain(*_t(*arrays), k2=k2)
    assert gd.shape == (b, k2) and gi.dtype == torch.int32
    assert not torch.isnan(gd).any()
    wd, wi = jref.ivf_scan_topk_ref(*_j(*arrays), k2)
    assert_candidates_match(gd, gi, wd, wi, tol=F32_TOL)
    td, ti = tref.ivf_scan_topk_ref(*_t(*arrays), k2=k2)
    assert_candidates_match(gd, gi, td, ti, tol=F32_TOL)


def test_f32_topk_plain_matches_pallas_kernel_in_interpret_mode():
    arrays = f32_case(6, 8, 8, 5, 3, seed=2, dead=0.2, masked=0.2, dup=True)
    gd, gi = tscan.ivf_scan_topk_plain(*_t(*arrays), k2=8)
    jd, ji = jops.ivf_scan_topk(*_j(*arrays), k2=8, bq=8)
    assert_candidates_match(gd, gi, jd, ji, tol=F32_TOL)


def test_f32_topk_duplicate_probe_scanned_once_and_dead_slots_dropped():
    arrays = list(f32_case(8, 4, 8, 4, 4, seed=0, masked=0.0))
    arrays[2] = np.full((4, 4), 3, np.int32)          # probe cluster 3 4x
    arrays[3] = np.ones((4, 4), bool)
    arrays[3][0] = False                               # query 0 masked
    arrays[1][3] = [10, -1, 12, 13]                    # one dead slot
    arrays[0][3, 1] = np.nan                           # ... holding NaN
    gd, gi = tscan.ivf_scan_topk_plain(*_t(*arrays), k2=8)
    gd, gi = gd.numpy(), gi.numpy()
    assert np.isinf(gd[0]).all() and (gi[0] == -1).all()
    for r in range(1, 4):
        assert sorted(gi[r][gi[r] >= 0].tolist()) == [10, 12, 13]
        assert np.isinf(gd[r][3:]).all() and np.isfinite(gd[r][:3]).all()


@pytest.mark.parametrize("where", NAN_WHERE)
def test_f32_topk_plain_follows_the_reference_on_a_nan_distance(where):
    """A NaN distance of a live row empties the query's candidates at that
    slot: the reference's ``_extract_topk`` gets a NaN from ``jnp.min``,
    emits (+inf, -1) k2 times and kills nothing.  Only the slots after it
    (clusters above it in the plan) refill the buffer.  The plain version
    against the Pallas kernel in interpret mode, then the rule itself."""
    arrays = f32_case(10, 8, 8, 12, 4, seed=21, dead=0.2, masked=0.1)
    clean = [a.copy() for a in arrays]
    post, ids, cids, mask, _ = arrays
    c = plant_nan(post, ids, cids, mask, where, q=1)
    gd, gi = tscan.ivf_scan_topk_plain(*_t(*arrays), k2=8)
    jd, ji = jops.ivf_scan_topk(*_j(*arrays), k2=8, bq=8)
    assert not torch.isnan(gd).any()
    assert_candidates_match(gd, gi, jd, ji, tol=F32_TOL)
    gi = gi.numpy()
    kept = gi[1][gi[1] >= 0]
    assert np.isin(kept, ids[c + 1:]).all()           # clusters after c only
    last = c == cids[1][mask[1] & (cids[1] >= 0)].max()
    assert (kept.size == 0) == last and last == (where == "last")
    if where == "one_query":                          # the tile's others
        clean[1], clean[2], clean[3] = ids, cids, mask
        _, ci = tscan.ivf_scan_topk_plain(*_t(*clean), k2=8)
        others = [r for r in range(8) if r != 1]
        np.testing.assert_array_equal(gi[others], ci.numpy()[others])


@pytest.mark.parametrize("c,l,d,b,p,masked", [(10, 8, 12, 5, 4, 0.3),
                                              (4, 16, 32, 9, 6, 0.0)])
def test_legacy_scan_plain_matches_jax(c, l, d, b, p, masked):
    post, _, cids, mask, queries = f32_case(c, l, d, b, p, seed=c * d,
                                            masked=masked)
    cids[0, 0] = c + 3                                  # clamped like JAX
    got = tscan.ivf_scan_plain(*_t(post, cids, mask, queries)).numpy()
    want = np.asarray(jref.ivf_scan_ref(*_j(post, cids, mask, queries)))
    assert got.shape == (b, p, l)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL * 10)
    assert (got[~mask] == np.inf).all()                # exactly +inf
    assert np.isfinite(got[mask]).all()
    if b * p <= 24:
        pallas = np.asarray(jops.ivf_scan(*_j(post, cids, mask, queries)))
        np.testing.assert_allclose(got, pallas, rtol=F32_TOL,
                                   atol=F32_TOL * 10)


@pytest.mark.parametrize("n,m,d", [(700, 9, 6), (64, 130, 3), (1, 1, 5),
                                   (300, 40, 128)])
def test_pairwise_l2_plain_bit_equal_to_jax_oracle(n, m, d):
    a, b = grid_points(n, m, d, seed=n + m)
    got = tpw.pairwise_l2_plain(*_t(a, b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.pairwise_l2_ref(
        *_j(a, b))))
    assert got.dtype == np.float32 and (got >= 0).all()


def test_pairwise_l2_plain_matches_pallas_kernel_in_interpret_mode():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(20, 12)).astype(np.float32)
    b = rng.normal(size=(33, 12)).astype(np.float32)
    got = tpw.pairwise_l2_plain(*_t(a, b)).numpy()
    want = np.asarray(jops.pairwise_l2(*_j(a, b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ops_dispatch_f32_kernels_to_plain_versions_on_cpu():
    arrays = _t(*f32_case(16, 8, 16, 8, 4, seed=5, dead=0.2))
    a, b = _t(*grid_points(50, 7, 4, seed=3))
    before = LAUNCHES.snapshot()
    gd, gi = tops.ivf_scan_topk(*arrays, k2=8)
    pd, pi = tscan.ivf_scan_topk_plain(*arrays, k2=8)
    assert torch.equal(gd, pd) and torch.equal(gi, pi)
    post, _, cids, mask, q = arrays
    assert torch.equal(tops.ivf_scan(post, cids, mask, q),
                       tscan.ivf_scan_plain(post, cids, mask, q))
    assert torch.equal(tops.pairwise_l2(a, b), tpw.pairwise_l2_plain(a, b))
    assert LAUNCHES.snapshot() == before          # plain versions launch none


def test_f32_cuda_wrappers_refuse_cpu_tensors():
    arrays = _t(*f32_case(16, 8, 16, 8, 4, seed=6))
    with pytest.raises(ValueError, match="needs CUDA"):
        tscan.ivf_scan_topk_cuda(*arrays, k2=8)
    post, _, cids, mask, q = arrays
    with pytest.raises(ValueError, match="needs CUDA"):
        tscan.ivf_scan_cuda(post, cids, mask, q)
    a, b = _t(*grid_points(10, 2, 3, seed=2))
    with pytest.raises(ValueError, match="needs CUDA"):
        tpw.pairwise_l2_cuda(a, b)
