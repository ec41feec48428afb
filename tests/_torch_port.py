"""Shared pieces of the port's tests (``tests/test_torch_*.py``): torch
thread limits, the card fixture, and the candidate comparison rule.

Usage in test modules:  ``from _torch_port import cuda, torch_threads``.
Nothing here imports JAX: the card-only tests run where JAX is absent.
"""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def torch_threads():
    """The suite runs several xdist workers; keep each one's torch pool
    small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def assert_candidates_match(gd, gi, wd, wi, tol=1e-4):
    """Distances elementwise within tol; ids equal except inside groups of
    tied distances, where only the id sets must agree (the rule of
    tests/test_fused_topk.py)."""
    gd, gi, wd, wi = (np.asarray(a) for a in (gd, gi, wd, wi))
    np.testing.assert_allclose(gd, wd, rtol=tol, atol=tol * 10)
    for r in range(gd.shape[0]):
        for j in range(gd.shape[1]):
            if np.isinf(wd[r, j]):
                assert gi[r, j] == -1 and wi[r, j] == -1
                continue
            tied = np.isclose(wd[r], wd[r, j], rtol=tol, atol=tol * 10)
            if tied.sum() == 1:
                assert gi[r, j] == wi[r, j], (r, j, gi[r], wi[r])
            else:
                assert set(gi[r][tied].tolist()) == set(wi[r][tied].tolist())


def q8_case(c, l, d, b, p, seed, dead=0.0, masked=0.2, dup=False):
    """Quantized postings (quantized by the reference's rule in numpy) with
    garbage codes in dead slots, plus a probe plan."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(c, d)).astype(np.float32)
    post = (cents[:, None, :]
            + 0.1 * rng.normal(size=(c, l, d))).astype(np.float32)
    ids = rng.permutation(4 * c * l)[: c * l].reshape(c, l).astype(np.int32)
    if dead:
        ids[rng.random(ids.shape) < dead] = -1
    r = np.where((ids >= 0)[:, :, None], post - cents[:, None, :], 0.0)
    amax = np.abs(r).max(axis=(1, 2), keepdims=True).astype(np.float32)
    scale = np.maximum(amax / np.float32(127.0), np.float32(1e-12))
    q8 = np.clip(np.round(r / scale), -127, 127).astype(np.int8)
    norm2 = (scale[:, :, 0] ** 2 * (q8.astype(np.float32) ** 2).sum(-1))
    q8[ids < 0] = rng.integers(-127, 128, size=(int((ids < 0).sum()), d))
    queries = (cents[rng.integers(0, c, size=b)]
               + 0.2 * rng.normal(size=(b, d))).astype(np.float32)
    cids = rng.integers(0, c, size=(b, p)).astype(np.int32)
    if dup:
        cids[:, 1] = cids[:, 0]
    mask = rng.random((b, p)) >= masked
    return (q8, scale.astype(np.float32), norm2.astype(np.float32), cents,
            ids, cids, mask, queries)


def f32_case(c, l, d, b, p, seed, dead=0.0, masked=0.2, dup=False,
             nan_dead=False):
    """f32 postings around random centroids and a probe plan:
    (postings, posting_ids, cids, mask, queries).  ``nan_dead`` fills the
    payload of dead slots (id < 0) with NaN, as stale pinned memory may."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(c, d)).astype(np.float32)
    post = (cents[:, None, :]
            + 0.3 * rng.normal(size=(c, l, d))).astype(np.float32)
    ids = rng.permutation(4 * c * l)[: c * l].reshape(c, l).astype(np.int32)
    if dead:
        ids[rng.random(ids.shape) < dead] = -1
    if nan_dead:
        post[ids < 0] = np.nan
    queries = (cents[rng.integers(0, c, size=b)]
               + 0.3 * rng.normal(size=(b, d))).astype(np.float32)
    cids = rng.integers(0, c, size=(b, p)).astype(np.int32)
    if dup:
        cids[:, 1] = cids[:, 0]
    mask = rng.random((b, p)) >= masked
    return post, ids, cids, mask, queries


def grid_points(n, k, d, seed):
    """Small integers: every distance, sum and count is exact in f32, and
    equal distances (ties) are common; centroid k // 2 duplicates centroid
    0, so the first index must win that tie."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    c = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
    c[k // 2] = c[0]
    return x, c
