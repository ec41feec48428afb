"""The batched Lloyd k-means (K23) and the lockstep splitter that drives it:
``kmeans_batched_plain`` against the JAX package's ``kmeans(fused=True)``
per sub-problem, ``balanced_hierarchical_kmeans_many`` against the JAX
package's splitter and the port's per-node one, ``enforce_size_bound``'s
batched 2-means against the JAX package and the per-cell loop, and
``build_index``'s stage 1 against the per-node splitters.  The CUDA kernel is held against
the plain version in test_torch_gpu.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import kmeans_batched_case as batched_case  # noqa: E402
from _torch_port import kmeans_data as _data  # noqa: E402
from _torch_port import per_cell_size_bound  # noqa: E402
from _torch_port import torch_threads  # noqa: E402,F401
from repro.build.kmeans import \
    balanced_hierarchical_kmeans as j_split  # noqa: E402
from repro.build.kmeans import kmeans as j_kmeans  # noqa: E402
from repro_torch.build.kmeans import SplitStats, \
    balanced_hierarchical_kmeans, balanced_hierarchical_kmeans_many, \
    enforce_size_bound  # noqa: E402
from repro_torch.kernels import kmeans_batched as tbatched  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.cuda_lib import LAUNCHES  # noqa: E402

ITERS = 5


@pytest.mark.parametrize("kind", ["grid", "gaussian"])
def test_kmeans_batched_plain_matches_jax_kmeans(kind):
    x, pts, offs, k, init, subs = batched_case(kind)
    before = LAUNCHES.snapshot()
    a, md, cents, counts = tops.kmeans_batched(x, pts, offs, k, init, ITERS)
    assert LAUNCHES.snapshot() == before          # plain versions launch none
    assert cents.shape == (len(subs), 16, x.shape[1])
    reseeded = 0
    for s, (rows, ks, seed) in enumerate(subs):
        lo, hi = int(offs[s]), int(offs[s + 1])
        np.testing.assert_array_equal(x[pts[lo:hi].long()].numpy(), rows)
        jc, ja, _ = j_kmeans(rows, ks, iters=ITERS, seed=seed, fused=True)
        ta, tc = a[lo:hi].numpy(), cents[s, :ks].numpy()
        if kind == "grid":
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(tc, jc)
        else:
            assert (ta == ja).mean() >= 0.99
            np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(counts[s, :ks].numpy(),
                                      np.bincount(ta, minlength=ks))
        assert not cents[s, ks:].any() and not counts[s, ks:].any()
        c0 = rows[init[s, :ks].numpy()]
        reseeded += len(np.unique(c0, axis=0)) < ks
    assert reseeded >= 1


def test_kmeans_batched_plain_is_the_per_node_loop():
    """On the CPU the batched plain version is ``build.kmeans.kmeans``
    exactly: every sub-problem's centroids, assignments and inertia."""
    from repro_torch.build.kmeans import kmeans as t_kmeans

    x, pts, offs, k, init, subs = batched_case("gaussian", d=16, seed=3)
    a, md, cents, _ = tbatched.kmeans_batched_plain(x, pts, offs, k, init,
                                                    ITERS)
    for s, (rows, ks, seed) in enumerate(subs):
        lo, hi = int(offs[s]), int(offs[s + 1])
        tc, ta, inertia = t_kmeans(rows, ks, iters=ITERS, seed=seed,
                                   device="cpu")
        np.testing.assert_array_equal(a[lo:hi].numpy(), ta)
        np.testing.assert_array_equal(cents[s, :ks].numpy(), tc)
        assert float(md[lo:hi].numpy().sum()) == inertia


def splitter_chunks(kind: str, d: int, seed: int):
    """Six chunks: a chunk of one repeated row (every split degenerates to
    the median split) and one already under the bound among them."""
    rng = np.random.default_rng(seed)
    chunks = [_data(kind, n, d, rng) for n in (400, 250, 330, 300, 30)]
    chunks.insert(3, np.repeat(_data(kind, 1, d, rng), 200, axis=0))
    return chunks


def test_many_matches_jax_splitter_on_grid_data():
    chunks = splitter_chunks("grid", 6, seed=11)
    st = SplitStats()
    got = balanced_hierarchical_kmeans_many(
        chunks, [1000 * i for i in range(6)], 40, iters=4, device="cpu",
        stats=st)
    assert len(got) == 6
    for i, (chunk, (gc, ga)) in enumerate(zip(chunks, got)):
        jc, ja = j_split(chunk, 40, iters=4, seed=1000 * i, fused=True)
        np.testing.assert_array_equal(gc, jc)
        np.testing.assert_array_equal(ga, ja)
        assert np.bincount(ga).max() <= 40
    assert got[5][0].shape[0] == 1                  # under the bound: 1 leaf
    assert got[3][0].shape[0] >= 5                  # median splits only
    assert st.steps >= 1 and st.subproblems >= st.steps
    assert st.kernel_ms == []                       # no card, no events


def test_many_matches_per_node_splitter_on_gaussian_data():
    chunks = splitter_chunks("gaussian", 16, seed=12)
    seeds = [7 + 1000 * i for i in range(6)]
    st = SplitStats()
    got = balanced_hierarchical_kmeans_many(chunks, seeds, 32, iters=6,
                                            device="cpu", stats=st)
    internal = 0
    for chunk, seed, (gc, ga) in zip(chunks, seeds, got):
        wc, wa = balanced_hierarchical_kmeans(chunk, 32, iters=6, seed=seed,
                                              device="cpu")
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(ga, wa)
        internal += wc.shape[0] > 1
    # one step per internal node of the deepest chunk, not per node
    assert internal <= st.steps < st.subproblems


def test_many_refuses_mismatched_seeds():
    with pytest.raises(ValueError, match="seeds"):
        balanced_hierarchical_kmeans_many([np.zeros((5, 2), np.float32)],
                                          [0, 1], 4, device="cpu")
    assert balanced_hierarchical_kmeans_many([], [], 4, device="cpu") == []


@pytest.mark.parametrize("kind", ["grid", "gaussian"])
def test_enforce_size_bound_batched_2means(kind):
    """A round's 2-means go through one K23 call; the result equals the
    JAX package's ``enforce_size_bound(fused=True)`` on grid data and the
    per-cell loop on both."""
    from repro.build.kmeans import enforce_size_bound as j_bound

    rng = np.random.default_rng(21)
    x = _data(kind, 1200, 6 if kind == "grid" else 16, rng)
    cents = x[:3].copy()
    got = enforce_size_bound(x, cents, 150, seed=5, device="cpu")
    assert got.shape[0] > 8                   # several rounds of splits
    np.testing.assert_array_equal(got, per_cell_size_bound(x, cents, 150,
                                                           seed=5))
    if kind == "grid":
        np.testing.assert_array_equal(got, j_bound(x, cents, 150, seed=5,
                                                   fused=True))


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_build_stage1_equals_per_node_splitters(tmp_path, n_workers):
    """Stage 1 of ``build_index`` (lockstep groups of chunks) saves the
    concatenation of the per-node splitters' centroids, split by
    ``enforce_size_bound`` exactly as before."""
    from repro_torch.build.pipeline import BuildConfig, _chunks, build_index
    from repro_torch.data.synthetic import PAPER_DATASETS, make_vectors

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=3000, dim=16,
                               n_modes=8)
    x = make_vectors(spec)
    cfg = BuildConfig(max_cluster_size=40, cluster_len=48,
                      coarse_per_task=500, n_workers=n_workers,
                      kmeans_iters=4, seed=3)
    _, _, report = build_index(x, cfg, str(tmp_path), device="cpu")
    parts = [balanced_hierarchical_kmeans(
        x[lo:hi], cfg.max_cluster_size, iters=cfg.kmeans_iters,
        seed=cfg.seed + 1000 * i, device="cpu")[0]
        for i, (lo, hi) in enumerate(_chunks(len(x), cfg.coarse_per_task))]
    want = enforce_size_bound(x, np.concatenate(parts),
                              min(cfg.max_cluster_size, cfg.cluster_len),
                              seed=cfg.seed, device="cpu")
    got = np.load(tmp_path / "stage1_centroids.npy")
    np.testing.assert_array_equal(got, want)
    assert len(report.stage1_split) == min(n_workers, 6)
    assert sum(s.steps for s in report.stage1_split) >= len(parts)
