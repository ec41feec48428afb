"""Shared pieces of the port's tests (``tests/test_torch_*.py``): torch
thread limits, the card fixture, and the candidate comparison rule.

Usage in test modules:  ``from _torch_port import cuda, torch_threads``.
``STEP_PARAM_ATOL`` is the tolerance of a recsys model's parameters after
one AdamW step, between two implementations (the port and the reference,
the card and the CPU).
Also the inputs shared by the CPU and card tests (``q8_case``, ``f32_case``,
``plant_nan``, ``grid_points``, ``kmeans_batched_case``) and
``per_cell_size_bound``.
Nothing here imports JAX: the card-only tests run where JAX is absent.
"""
import numpy as np
import pytest
import torch


# the parameters after one AdamW step: the step moves each by at most lr
# (3e-4), by about lr * sign(g) where |g| >> eps, and where |g| is near eps
# by an amount that amplifies a difference in g; on the CPU the port and
# the reference agree within 1.2e-6 (tests/test_torch_recsys.py), so this
# holds them to a thirtieth of lr
STEP_PARAM_ATOL = 1e-5


def adamw_step_gap(mu_a, nu_a, mu_b, nu_b, cfg=None) -> np.ndarray:
    """lr * |u_a - u_b| elementwise, u = mhat / (sqrt(vhat) + eps) of
    AdamW's first step from moments a and b: how far one step moves the
    same parameters apart for two gradients.  Where |g| >> eps it is
    ~lr * eps * |g_a - g_b| / g^2, nothing; where |g| is near eps the
    update g / (|g| + eps) magnifies the gradients' difference by up to
    1 / (4 eps), so two float32 evaluations whose gradients agree within
    1e-6 of their scale can move such an element by different amounts."""
    from repro_torch.optim.adamw import AdamWConfig

    cfg = cfg or AdamWConfig()
    f64 = lambda x: np.asarray(x, np.float64)
    u = lambda m, v: (f64(m) / (1 - cfg.b1)) / (
        np.sqrt(f64(v) / (1 - cfg.b2)) + cfg.eps)
    return cfg.lr * np.abs(u(mu_a, nu_a) - u(mu_b, nu_b))


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


def assert_candidates_match(gd, gi, wd, wi, tol=1e-4, boundary=False):
    """Distances elementwise within tol; ids equal except inside groups of
    tied distances, where only the id sets must agree (the rule of
    tests/test_fused_topk.py).  ``boundary``: a group tied with the last
    column may continue past it, so its ids may differ, as chip_smoke.py's
    ``candidates_match`` allows (two scans that sum in other orders can
    swap a near-tie at the k-th boundary; tens of thousands of candidates a
    query make such ties common)."""
    gd, gi, wd, wi = (np.asarray(a) for a in (gd, gi, wd, wi))
    np.testing.assert_allclose(gd, wd, rtol=tol, atol=tol * 10)
    for r in range(gd.shape[0]):
        for j in range(gd.shape[1]):
            if np.isinf(wd[r, j]):
                assert gi[r, j] == -1 and wi[r, j] == -1
                continue
            tied = np.isclose(wd[r], wd[r, j], rtol=tol, atol=tol * 10)
            if boundary and tied[-1]:
                continue
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
             nan_dead=False, dup_ids=False):
    """f32 postings around random centroids and a probe plan:
    (postings, posting_ids, cids, mask, queries).  ``nan_dead`` fills the
    payload of dead slots (id < 0) with NaN, as stale pinned memory may;
    ``dup_ids`` gives each cluster of the upper half the ids of one of the
    lower half (a replicated row in two clusters, with another vector)."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(c, d)).astype(np.float32)
    post = (cents[:, None, :]
            + 0.3 * rng.normal(size=(c, l, d))).astype(np.float32)
    ids = rng.permutation(4 * c * l)[: c * l].reshape(c, l).astype(np.int32)
    if dup_ids:
        ids[c // 2:] = ids[rng.integers(0, c // 2, size=c - c // 2)]
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


NAN_WHERE = ("first", "middle", "last", "one_query")


def plant_nan(target, ids, cids, mask, where, q=0, bq=8):
    """Make one live row's distance NaN for query ``q``: a NaN in the f32
    payload (C, L, D) or in the q8 ``norm2`` (C, L) of a row with id >= 0
    in the first, a middle or the last cluster of q's plan (its live probes
    in ascending cluster order, the order of the scan's slots), or, for
    "one_query", of a middle cluster that no other query of q's tile of
    ``bq`` probes (q also probes the last cluster with a live row, a slot
    after it).  Takes numpy arrays (the numpy views of CPU tensors too:
    ``chip_smoke.py`` plants its cases with this), edits them in place;
    returns the cluster."""
    c_n = ids.shape[0]
    if where == "one_query":
        c = c_n // 2
        t0 = q // bq * bq
        for r in range(t0, min(t0 + bq, cids.shape[0])):
            if r != q:
                cids[r][cids[r] == c] = 0
        cids[q, 0], mask[q, 0] = c, True
        cids[q, 1] = np.nonzero((ids >= 0).any(axis=1))[0][-1]
        mask[q, 1] = True
    else:
        plan = np.unique(cids[q][mask[q] & (cids[q] >= 0)])
        c = int(plan[{"first": 0, "middle": len(plan) // 2,
                      "last": -1}[where]])
    rows = np.nonzero(ids[c] >= 0)[0]
    r = int(rows[len(rows) // 2]) if rows.size else 0
    if not rows.size:
        ids[c, 0] = ids.max() + 1
    if target.ndim == 3:
        target[c, r, 0] = np.nan
    else:
        target[c, r] = np.nan
    return c


def grid_points(n, k, d, seed):
    """Small integers: every distance, sum and count is exact in f32, and
    equal distances (ties) are common; centroid k // 2 duplicates centroid
    0, so the first index must win that tie."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    c = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
    c[k // 2] = c[0]
    return x, c


def kmeans_data(kind: str, n: int, d: int, rng) -> np.ndarray:
    """(n, d) f32: small integers ("grid": every distance and sum exact,
    ties common) or standard normals."""
    if kind == "grid":
        return rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    return rng.normal(size=(n, d)).astype(np.float32)


def _dup_seed(x: np.ndarray, k: int) -> int:
    """The first seed whose initial centroids (the reference's draw) hold
    two equal rows: the later one gets no point at the first E-step (ties
    go to the lower index), so that cluster is reseeded."""
    for seed in range(1000):
        init = x[np.random.default_rng(seed).choice(len(x), k, replace=False)]
        if len(np.unique(init, axis=0)) < k:
            return seed
    raise AssertionError("no seed draws a repeated row")


def kmeans_batched_case(kind: str, d: int = 6, seed: int = 0):
    """Sub-problems of several sizes (k = 1 and k = 16 among them, one with
    a reseeded empty cluster), their rows scattered over one x in a random
    order: (x, pts, offs, k, init, [(rows, k, seed)])."""
    rng = np.random.default_rng(seed)
    subs = []
    for n, k in ((50, 1), (300, 16), (200, 8), (97, 3), (64, 2)):
        subs.append([kmeans_data(kind, n, d, rng), k,
                     int(rng.integers(1 << 20))])
    # 40 copies of 3 points, then 10 far points: the reseed takes far
    # points, whose min distances no rounding can reorder
    rep = np.concatenate([
        np.repeat(kmeans_data(kind, 3, d, rng), [30, 6, 4], 0),
        4 * kmeans_data(kind, 10, d, rng)])
    subs.append([rep, 5, _dup_seed(rep, 5)])
    rows = np.concatenate([s[0] for s in subs])
    perm = rng.permutation(len(rows))
    x = rows[perm]
    where = np.argsort(perm)                  # row i of `rows` is x[where[i]]
    pts, offs, ks, init, at = [], [0], [], [], 0
    for sub, k, sd in subs:
        pts.append(where[at:at + len(sub)])
        at += len(sub)
        offs.append(at)
        ks.append(k)
        row = np.zeros(16, np.int32)
        row[:k] = np.random.default_rng(sd).choice(len(sub), k, replace=False)
        init.append(row)
    to = [torch.from_numpy(np.asarray(a, np.int32))
          for a in (np.concatenate(pts), offs, ks, np.stack(init))]
    return (torch.from_numpy(x), *to, [(s[0], s[1], s[2]) for s in subs])


def per_cell_size_bound(x, cents, bound, seed=0, device="cpu",
                        max_rounds=20):
    """``enforce_size_bound`` as the reference writes it: one fused
    ``kmeans`` (K2, sort, K3) per oversized cell, taken as ``x[a == c]``."""
    from repro_torch.build.kmeans import kmeans
    from repro_torch.kernels import ops

    xd = torch.from_numpy(x).to(device)
    cents = cents.copy()
    for rnd in range(max_rounds):
        a, _, _, counts = ops.kmeans_assign_update(
            xd, torch.from_numpy(cents).to(device))
        a, counts = a.cpu().numpy(), counts.cpu().numpy()
        over = np.nonzero(counts > bound)[0]
        if over.size == 0:
            break
        new_rows = []
        for c in over:
            sub, _, _ = kmeans(x[a == c], 2, iters=4,
                               seed=seed + 131 * rnd + int(c), device=device)
            cents[c] = sub[0]
            new_rows.append(sub[1])
        cents = np.concatenate([cents, np.stack(new_rows)], axis=0)
    return cents
