"""The port's core modules against the JAX package on identical numpy
inputs: distance, dedup and merge helpers, int8 quantization, GBDT
inference and training, the plan stage (centroid scan + LLSP), closure
assignment, posting build and the fused k-means loop."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import torch_threads  # noqa: E402,F401
from repro.core import distance as jd  # noqa: E402
from repro_torch.core import distance as td  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -------------------------------------------------------------------------
# distance helpers
# -------------------------------------------------------------------------
def test_squared_l2_and_chunked_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(7, 12)).astype(np.float32)
    b = rng.normal(size=(50, 12)).astype(np.float32)
    want = np.asarray(jd.squared_l2(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(td.squared_l2(_t(a), _t(b)).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        td.squared_l2_chunked(_t(a), _t(b), chunk=16).numpy(), want,
        rtol=1e-5, atol=1e-5)


def test_topk_smallest_tie_order_matches_jax():
    rng = np.random.default_rng(1)
    d = rng.integers(0, 4, size=(6, 30)).astype(np.float32)  # many ties
    jv, ji = jd.topk_smallest(jnp.asarray(d), 11)
    tv, ti = td.topk_smallest(_t(d), 11)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _dup_candidates(b, n, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 50, size=(b, n)).astype(np.float32)
    ids = rng.integers(-1, n // 3, size=(b, n)).astype(np.int32)
    d[rng.random(d.shape) < 0.1] = np.inf
    return d, ids


@pytest.mark.parametrize("n,k", [(40, 10), (40, 60), (300, 24)])
def test_dedup_and_merge_bit_equal_to_jax(n, k):
    d, ids = _dup_candidates(5, n, seed=n + k)
    for jf, tf in ((jd.dedup_topk, td.dedup_topk),
                   (jd.merge_candidate_topk, td.merge_candidate_topk)):
        jv, ji = jf(jnp.asarray(d), jnp.asarray(ids), k)
        tv, ti = tf(_t(d), _t(ids), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.integers(0, 30, size=(8, 10))
    t = rng.integers(0, 30, size=(8, 10))
    assert td.recall_at_k(p, t) == jd.recall_at_k(p, t)


# -------------------------------------------------------------------------
# quantization
# -------------------------------------------------------------------------
def test_quantize_postings_bit_equal_with_dead_slots():
    from repro.core.quantize import quantize_postings as jq
    from repro_torch.core.quantize import quantize_postings as tq

    rng = np.random.default_rng(3)
    cents = rng.normal(size=(12, 16)).astype(np.float32)
    post = (cents[:, None, :] + 0.2 * rng.normal(size=(12, 20, 16))
            ).astype(np.float32)
    ids = rng.integers(0, 1000, size=(12, 20)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    post[ids < 0] += 50.0                     # drifted dead payload
    ids[5] = -1                               # a fully dead cluster
    for pid in (ids, None):
        j = jq(jnp.asarray(post), jnp.asarray(cents),
               None if pid is None else jnp.asarray(pid))
        t = tq(_t(post), _t(cents), None if pid is None else _t(pid))
        np.testing.assert_array_equal(t.q8.numpy(), np.asarray(j.q8))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        np.testing.assert_array_equal(t.norm2.numpy(), np.asarray(j.norm2))
    assert (t.q8.numpy() >= -127).all()
    t = tq(_t(post), _t(cents), _t(ids))
    assert (t.q8.numpy()[ids < 0] == 0).all()
    assert (t.norm2.numpy()[ids < 0] == 0).all()


# -------------------------------------------------------------------------
# GBDT and LLSP
# -------------------------------------------------------------------------
def _regression(n=300, f=9, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = 3.0 * (x[:, 0] > 0.2) + x[:, 1] ** 2 + 0.1 * rng.normal(size=n)
    return x, y


def test_gbdt_fit_identical_and_predict_matches_jax():
    from repro.core.gbdt import GBDTRegressor as JReg
    from repro.core.gbdt import predict_jax
    from repro_torch.core.gbdt import GBDTRegressor as TReg
    from repro_torch.core.gbdt import predict

    x, y = _regression()
    jm = JReg(n_trees=12, max_depth=4, seed=1).fit(x, y)
    tm = TReg(n_trees=12, max_depth=4, seed=1).fit(x, y)
    for f in ("feature", "threshold", "value", "base", "lr"):
        np.testing.assert_array_equal(getattr(tm.params, f).numpy(),
                                      np.asarray(getattr(jm.params, f)))
    want = np.asarray(predict_jax(jm.params, jnp.asarray(x)))
    np.testing.assert_allclose(predict(tm.params, _t(x)).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.predict(x), jm.predict(x), rtol=1e-5,
                               atol=1e-5)


def test_gbdt_stacked_predict_matches_jax():
    from repro.core.gbdt import GBDTRegressor as JReg
    from repro.core.gbdt import predict_stacked_jax
    from repro.core.gbdt import stack_params as jstack
    from repro_torch import convert
    from repro_torch.core.gbdt import predict_stacked

    x, y = _regression(seed=5)
    models = [JReg(n_trees=6, max_depth=3, seed=s).fit(x, y + s).params
              for s in range(3)]
    stacked = jstack(models)
    level = np.random.default_rng(6).integers(0, 3, size=len(x))
    want = np.asarray(predict_stacked_jax(stacked, jnp.asarray(level),
                                          jnp.asarray(x)))
    tp = convert.gbdt_params(convert.gbdt_arrays(stacked), device="cpu")
    got = predict_stacked(tp, _t(level), _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def plan_case(small_index, small_corpus):
    from repro.build.pipeline import train_llsp_for_index
    from repro.core.llsp import LLSPConfig

    x, q, topk = small_corpus
    llsp = train_llsp_for_index(
        LLSPConfig(levels=(8, 16), n_ratio_features=8, n_trees=20,
                   max_depth=4), small_index, x, q, np.minimum(topk, 20))
    return small_index, llsp, x, q


def test_plan_stage_nprobe_mismatch_within_one_percent(plan_case):
    """Centroid scan + LLSP route + prune, JAX vs port on converted
    params.  The GBDT split is a hard ``<=`` on float features, so a
    last-bit difference can flip a decision: gate the mismatch rate."""
    from repro.core.search import SearchConfig as JCfg
    from repro.core.search import centroid_scan as jscan
    from repro.core.search import decide_nprobe as jdecide
    from repro_torch import convert
    from repro_torch.core.search import SearchConfig, centroid_scan, \
        decide_nprobe

    index, llsp, x, _ = plan_case
    rng = np.random.default_rng(7)
    q = (x[rng.integers(0, len(x), size=400)]
         + 0.3 * rng.normal(size=(400, x.shape[1]))).astype(np.float32)
    tk = rng.integers(1, 50, size=400).astype(np.int32)
    jcfg = JCfg(k=10, nprobe_max=16, pruning="llsp", n_ratio=8)
    jcd, jcids = jscan(index, jnp.asarray(q), 16, jcfg)
    jnp_ = np.asarray(jdecide(jcfg, llsp, jnp.asarray(q), jnp.asarray(tk),
                              jcd))
    tindex = convert.ivf_index(np.asarray(index.centroids),
                               np.asarray(index.postings),
                               np.asarray(index.posting_ids), device="cpu")
    tllsp = convert.llsp_from_reference(llsp, device="cpu")
    cd, cids = centroid_scan(tindex, _t(q), 16)
    got = decide_nprobe(SearchConfig(k=10, nprobe_max=16, pruning="llsp",
                                     n_ratio=8), tllsp, _t(q), _t(tk), cd)
    np.testing.assert_allclose(cd.numpy(), np.asarray(jcd), rtol=1e-4,
                               atol=1e-4)
    assert (cids.numpy() == np.asarray(jcids)).mean() >= 0.99
    mismatch = float((got.numpy() != jnp_).mean())
    assert mismatch <= 0.01, mismatch
    assert got.dtype == torch.int32


def test_fixed_eps_and_none_pruning_match_jax():
    from repro.core.spann_rules import fixed_eps_nprobe as jf
    from repro_torch.core.spann_rules import fixed_eps_nprobe as tf

    rng = np.random.default_rng(8)
    cd = np.sort(rng.uniform(1, 3, size=(20, 16)).astype(np.float32), axis=1)
    np.testing.assert_array_equal(tf(_t(cd), 0.12, 16).numpy(),
                                  np.asarray(jf(jnp.asarray(cd), 0.12, 16)))


def test_llsp_training_labels_match_jax():
    from repro.core import llsp as jl
    from repro_torch.core import llsp as tl

    rng = np.random.default_rng(9)
    ranks = rng.integers(0, 16, size=(30, 12)).astype(np.int32)
    tk = rng.integers(1, 13, size=30)
    np.testing.assert_array_equal(
        tl.min_nprobe_labels(ranks, 0.9, 16, topk=tk),
        jl.min_nprobe_labels(ranks, 0.9, 16, topk=tk))
    pids = rng.integers(-1, 200, size=(20, 10)).astype(np.int32)
    true = rng.integers(-1, 200, size=(30, 6)).astype(np.int32)
    order = np.stack([rng.permutation(20)[:16] for _ in range(30)])
    np.testing.assert_array_equal(
        tl.first_hit_ranks(true, order, pids, 200, 16),
        jl.first_hit_ranks(true, order, pids, 200, 16))


# -------------------------------------------------------------------------
# build path pieces
# -------------------------------------------------------------------------
def test_closure_assign_and_build_postings_match_jax(small_corpus):
    from repro.build.kmeans import balanced_hierarchical_kmeans
    from repro.core.ivf import build_postings as jbuild
    from repro.core.spann_rules import closure_assign as jclosure
    from repro_torch.core.ivf import build_postings as tbuild
    from repro_torch.core.spann_rules import closure_assign as tclosure

    x, _, _ = small_corpus
    x = x[:1500]
    cents, _ = balanced_hierarchical_kmeans(x, 48, iters=4)
    want = np.asarray(jclosure(jnp.asarray(x), jnp.asarray(cents), eps=0.6,
                               max_replicas=4, chunk=512))
    got = tclosure(_t(x), _t(cents), eps=0.6, max_replicas=4,
                   chunk=512).numpy()
    assert (got == want).mean() >= 0.999
    assert (want[:, 1:] >= 0).any()           # replicas exist in this case
    for cl in (16, 64):
        jp, ji = jbuild(x, want, cents.shape[0], cl)
        tp, ti = tbuild(x, want, cents.shape[0], cl)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("fused", [True, False])
def test_fused_kmeans_loop_matches_jax(small_corpus, fused):
    """The k-means loop on both data paths: fused (K2/K3 plain versions)
    and unfused (pairwise_l2 tile + argmin, host float64 M-step)."""
    from repro.build.kmeans import kmeans as jkmeans
    from repro_torch.build.kmeans import kmeans as tkmeans

    x, _, _ = small_corpus
    x = x[:2000]
    jc, ja, ji = jkmeans(x, 12, iters=6, seed=3, fused=fused)
    tc, ta, ti = tkmeans(x, 12, iters=6, seed=3, fused=fused, device="cpu")
    assert (ta == ja).mean() >= 0.99
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    assert ti == pytest.approx(ji, rel=1e-4)
    if not fused:     # grid data: every distance and sum exact, ties common
        from repro_torch.build.kmeans import enforce_size_bound

        g = np.random.default_rng(5).integers(-4, 5, size=(600, 6))
        g = g.astype(np.float32)
        jc, ja, ji = jkmeans(g, 9, iters=5, seed=1, fused=False)
        tc, ta, ti = tkmeans(g, 9, iters=5, seed=1, fused=False,
                             device="cpu")
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tc, jc)
        assert ti == ji
        from repro.build.kmeans import enforce_size_bound as jbound

        np.testing.assert_array_equal(
            enforce_size_bound(g, tc[:3], 150, fused=False, device="cpu"),
            jbound(g, jc[:3], 150, fused=False))


def test_synthetic_corpus_identical_to_reference():
    from repro.data import synthetic as js
    from repro_torch.data import synthetic as ts

    spec = dataclasses.replace(ts.PAPER_DATASETS["sift"], n=500, dim=16)
    jspec = dataclasses.replace(js.PAPER_DATASETS["sift"], n=500, dim=16)
    np.testing.assert_array_equal(ts.make_vectors(spec),
                                  js.make_vectors(jspec))
    for a, b in zip(ts.make_queries(spec, 20), js.make_queries(jspec, 20)):
        np.testing.assert_array_equal(a, b)
