"""The port's slice end to end: the q8 host tier's fetch contract, the
flash tier, the serving pipeline against the JAX pipeline on the same
JAX-built index (carried over by ``repro_torch.convert``), the port's own
index build (recall gate and resume hash), and the entry points' refusal
to drop to the CPU on their own."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_candidates_match, torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.core.distance import recall_at_k  # noqa: E402
from repro_torch.core.search import SearchConfig  # noqa: E402

SERVE = dict(k=10, nprobe_max=16, pruning="llsp", n_ratio=8)


def _batches(q, size=16):
    return [(q[i:i + size], np.full(len(q[i:i + size]), 10, np.int32))
            for i in range(0, len(q), size)]


# -------------------------------------------------------------------------
# host tier + flash tier
# -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def q8_arrays(small_index):
    from repro.core.quantize import quantize_postings

    qp = quantize_postings(small_index.postings, small_index.centroids,
                           small_index.posting_ids)
    return (np.asarray(qp.q8), np.asarray(qp.scale), np.asarray(qp.norm2),
            np.asarray(small_index.centroids),
            np.asarray(small_index.posting_ids))


@pytest.mark.parametrize("bucket,pad_rows", [(1, None), (16, None), (8, 40)])
def test_q8_fetch_contract_matches_reference(q8_arrays, bucket, pad_rows):
    from repro.storage.host_tier import QuantizedTieredPostings as JTier
    from repro_torch.storage.host_tier import QuantizedTieredPostings

    rng = np.random.default_rng(bucket)
    c = q8_arrays[0].shape[0]
    cids = rng.integers(-1, c, size=(6, 5)).astype(np.int32)
    cids[1] = cids[0]                                 # shared union rows
    mask = rng.random(cids.shape) < 0.7
    jt = JTier(*q8_arrays)
    tt = QuantizedTieredPostings(*q8_arrays, device="cpu")
    want = jt.fetch(cids, mask, pad_rows=pad_rows, bucket=bucket)
    got = tt.fetch(cids, mask, pad_rows=pad_rows, bucket=bucket)
    u = tt.stats.events[-1].clusters_union
    assert u == jt.stats.events[-1].clusters_union
    assert got.ready is None                          # CPU: no copy stream
    for g, w in zip(got.tensors(), want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:u] if g.ndim == 3 else g[:u],
                                      w[:u])
    q8, scale, norm2, cents, ids, remap = (t.numpy() for t in got.tensors())
    np.testing.assert_array_equal(remap, np.asarray(want[5]))
    assert q8.shape[0] % bucket == 0 and q8.shape[0] >= u + 1
    assert (ids[u:] == -1).all() and (norm2[u:] == 0).all()
    assert (scale[u:] == 1).all() and (cents[u:] == 0).all()
    live = mask & (cids >= 0)
    assert (remap[~live] == u).all()                  # masked -> sentinel
    ev = tt.stats.events[-1]
    assert ev.clusters_requested == int(live.sum())
    assert ev.union_bytes == u * tt.cluster_bytes
    assert tt.nbytes() == jt.nbytes()
    tt.release()
    with pytest.raises(RuntimeError, match="released"):
        tt.fetch(cids, mask)


def test_flash_tier_read_dedup(tmp_path):
    from repro_torch.storage.flash_tier import FlashTier

    x = np.random.default_rng(0).normal(size=(50, 6)).astype(np.float32)
    ft = FlashTier(x, str(tmp_path / "f.f32"))
    uids, rows = ft.read(np.array([[4, 2, 4, -1], [2, 9, -1, -1]]))
    np.testing.assert_array_equal(uids, [2, 4, 9])
    np.testing.assert_array_equal(rows, x[[2, 4, 9]])
    assert ft.stats.events[-1].requested == 5
    ft.release()
    ft.release()


# -------------------------------------------------------------------------
# the slice: port pipeline vs JAX pipeline on one JAX-built index
# -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_built(small_index, small_corpus):
    from repro.build.pipeline import train_llsp_for_index
    from repro.core.llsp import LLSPConfig

    x, q, topk = small_corpus
    llsp = train_llsp_for_index(
        LLSPConfig(levels=(8, 16), n_ratio_features=8, n_trees=20,
                   max_depth=4), small_index, x, q, np.minimum(topk, 20))
    rng = np.random.default_rng(11)
    queries = (x[rng.integers(0, len(x), size=96)]
               + 0.2 * rng.normal(size=(96, x.shape[1]))).astype(np.float32)
    from repro.core.ivf import brute_force_topk

    _, true10 = brute_force_topk(jnp.asarray(x), jnp.asarray(queries), 10)
    return small_index, llsp, x, queries, np.asarray(true10)


@pytest.mark.parametrize("use_kernel,with_flash", [(True, True),
                                                   (True, False),
                                                   (False, True)])
def test_pipeline_matches_jax_pipeline(jax_built, tmp_path, use_kernel,
                                       with_flash):
    from repro.core.search import SearchConfig as JCfg
    from repro.runtime import make_quantized_pipeline as j_make
    from repro_torch.runtime.pipeline import (
        inflight_depth, make_quantized_pipeline, overlap_efficiency,
        rerank_overlap_efficiency)

    index, llsp, x, queries, true10 = jax_built
    jpipe = j_make(index, llsp, JCfg(**SERVE, use_kernel=False),
                   vectors=x, with_flash=with_flash,
                   flash_path=str(tmp_path / "j.f32"))
    want = jpipe.run_pipelined(_batches(queries), depth=2)
    tindex = convert.ivf_index(np.asarray(index.centroids),
                               np.asarray(index.postings),
                               np.asarray(index.posting_ids), device="cpu")
    tpipe = make_quantized_pipeline(
        tindex, convert.llsp_from_reference(llsp, device="cpu"),
        SearchConfig(**SERVE, use_kernel=use_kernel), vectors=x,
        with_flash=with_flash, flash_path=str(tmp_path / "t.f32"),
        device="cpu")
    try:
        got = tpipe.run_pipelined(_batches(queries), depth=2)
    finally:
        tpipe.close()
    g_ids = np.concatenate([o.ids for o in got])
    g_d = np.concatenate([o.dists for o in got])
    g_np = np.concatenate([o.nprobe for o in got])
    w_ids = np.concatenate([o.ids for o in want])
    w_d = np.concatenate([o.dists for o in want])
    w_np = np.concatenate([o.nprobe for o in want])
    same = g_np == w_np
    assert (~same).mean() <= 0.01                    # LLSP flips
    assert_candidates_match(g_d[same], g_ids[same], w_d[same], w_ids[same],
                            tol=1e-3)
    r_got, r_want = recall_at_k(g_ids, true10), recall_at_k(w_ids, true10)
    assert abs(r_got - r_want) <= 0.01, (r_got, r_want)
    assert r_got >= 0.9
    times = [o.times for o in got]
    assert 0.0 <= overlap_efficiency(times) <= 1.0
    assert 1 <= inflight_depth(times) <= 2
    if with_flash:
        assert all(o.quality is not None for o in got)
        assert 0.0 <= rerank_overlap_efficiency(times) <= 1.0
        assert all(t.rerank_rounds >= 1 for t in times)


def test_sequential_and_serve_batch_agree_with_pipelined(jax_built, tmp_path):
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    index, llsp, x, queries, _ = jax_built
    tindex = convert.ivf_index(np.asarray(index.centroids),
                               np.asarray(index.postings),
                               np.asarray(index.posting_ids), device="cpu")
    pipe = make_quantized_pipeline(
        tindex, convert.llsp_from_reference(llsp, device="cpu"),
        SearchConfig(**SERVE), vectors=x, flash_path=str(tmp_path / "f.f32"),
        device="cpu")
    try:
        assert pipe.warmup() == 2
        bs = _batches(queries[:40])
        a = pipe.run_pipelined(bs, depth=3)
        b = pipe.run_sequential(bs)
        c = [pipe.serve_batch(*bt) for bt in bs]
    finally:
        pipe.close()
    for ra, rb, rc in zip(a, b, c):
        np.testing.assert_array_equal(ra.ids, rb.ids)
        np.testing.assert_array_equal(ra.ids, rc.ids)
    assert [len(r.ids) for r in a] == [16, 16, 8]


# -------------------------------------------------------------------------
# the port's own build
# -------------------------------------------------------------------------
GATE_CFG = dict(max_cluster_size=48, cluster_len=64, coarse_per_task=1000,
                n_workers=2)


@pytest.fixture(scope="module")
def port_build(tmp_path_factory, small_corpus):
    from repro_torch.build.pipeline import BuildConfig, build_index
    from repro_torch.core.llsp import LLSPConfig

    x, q, topk = small_corpus
    cfg = BuildConfig(**GATE_CFG, llsp=LLSPConfig(
        levels=(8, 16, 32, 48), recall_target=0.97, n_ratio_features=8,
        n_trees=30, max_depth=4))
    wd = str(tmp_path_factory.mktemp("port_build"))
    idx, llsp, report = build_index(x, cfg, wd, queries=q,
                                    query_topk=np.minimum(topk, 20),
                                    device="cpu")
    return idx, llsp, report, cfg, wd


def test_port_build_passes_q8_recall_gate(port_build, small_corpus):
    from repro_torch.core.ivf import brute_force_topk
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    idx, llsp, report, _, _ = port_build
    x, q, _ = small_corpus
    assert report.n_clusters > 10 and report.replication >= 1.0
    assert int((idx.posting_ids >= 0).sum()) >= len(x)
    pipe = make_quantized_pipeline(
        idx, llsp, SearchConfig(k=10, nprobe_max=48, pruning="llsp",
                                n_ratio=8), with_flash=False, device="cpu")
    try:
        out = pipe.run_pipelined(_batches(q, 32), depth=2)
    finally:
        pipe.close()
    _, true10 = brute_force_topk(torch.from_numpy(x), torch.from_numpy(q),
                                 10)
    r = recall_at_k(np.concatenate([o.ids for o in out]), true10.numpy())
    assert r >= 0.95, r


def test_port_build_resumes_to_the_same_hash(port_build, small_corpus,
                                             tmp_path):
    from repro_torch.build.pipeline import build_index, index_content_hash

    idx, _, _, cfg, wd = port_build
    x, q, topk = small_corpus
    h = index_content_hash(idx)
    resumed, _, rep = build_index(x, cfg, wd, device="cpu")
    assert rep.resumed_stages == ["stage1", "stage2"]
    assert index_content_hash(resumed) == h
    fresh, _, rep = build_index(x, cfg, str(tmp_path / "fresh"),
                                device="cpu")
    assert rep.resumed_stages == []
    assert index_content_hash(fresh) == h


def test_unfused_build_names_the_missing_kernel(small_corpus, tmp_path):
    """The unfused build, ``BuildConfig(fused_assign=False)`` (the
    ``pairwise_l2`` tile + argmin, host float64 M-step), passes the q8
    recall gate and resumes to the same hash."""
    from repro_torch.build.pipeline import BuildConfig, build_index, \
        index_content_hash
    from repro_torch.core.ivf import brute_force_topk
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    x, q, _ = small_corpus
    cfg = BuildConfig(**GATE_CFG, fused_assign=False)
    wd = str(tmp_path / "unfused")
    idx, _, report = build_index(x, cfg, wd, device="cpu")
    assert report.n_clusters > 10 and report.replication >= 1.0
    pipe = make_quantized_pipeline(
        idx, None, SearchConfig(k=10, nprobe_max=24, pruning="none"),
        with_flash=False, device="cpu")
    try:
        out = pipe.run_pipelined(_batches(q, 32), depth=2)
    finally:
        pipe.close()
    _, true10 = brute_force_topk(torch.from_numpy(x), torch.from_numpy(q),
                                 10)
    r = recall_at_k(np.concatenate([o.ids for o in out]), true10.numpy())
    assert r >= 0.95, r
    resumed, _, rep = build_index(x, cfg, wd, device="cpu")
    assert rep.resumed_stages == ["stage1", "stage2"]
    assert index_content_hash(resumed) == index_content_hash(idx)
    fresh, _, _ = build_index(x, cfg, str(tmp_path / "fresh"), device="cpu")
    assert index_content_hash(fresh) == index_content_hash(idx)


# -------------------------------------------------------------------------
# entry points never drop to the CPU on their own
# -------------------------------------------------------------------------
def test_entry_points_raise_without_a_card(monkeypatch, small_corpus,
                                           tmp_path, q8_arrays):
    from repro_torch.build.pipeline import BuildConfig, build_index
    from repro_torch.runtime.pipeline import PrefetchPipeline, \
        make_quantized_pipeline
    from repro_torch.storage.host_tier import QuantizedTieredPostings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _, _ = small_corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index(x[:200], BuildConfig(**GATE_CFG), str(tmp_path))
    idx = convert.ivf_index(q8_arrays[3], np.zeros((q8_arrays[0].shape),
                                                   np.float32),
                            q8_arrays[4], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_quantized_pipeline(idx, None, SearchConfig(), with_flash=False)
    tier = QuantizedTieredPostings(*q8_arrays, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchPipeline(idx, None, SearchConfig(), tier)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuantizedTieredPostings(*q8_arrays)
    with pytest.raises(RuntimeError, match="CUDA is absent"):
        build_index(x[:200], BuildConfig(**GATE_CFG), str(tmp_path),
                    device="cuda")


# -------------------------------------------------------------------------
# the reference's pipeline switches: auto_round, max_rounds, quality_proxy,
# warmup(max_rows=)
# -------------------------------------------------------------------------
def _switch_pipes(small_index, x, tmp_path, tag, rerank, **kw):
    """The port's and the JAX package's q8 pipelines with the flash re-rank
    over one index, at the reference test's config (pruning "none",
    plain scans)."""
    from repro.core.search import SearchConfig as JCfg
    from repro.runtime import make_quantized_pipeline as j_make
    from repro.runtime import RerankConfig as JRerank
    from repro_torch.runtime import RerankConfig
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    cfg = dict(k=10, nprobe_max=16, pruning="none", use_kernel=False,
               fused_topk=True)
    jp = j_make(small_index, None, JCfg(**cfg), vectors=x, name=f"j{tag}",
                flash_path=str(tmp_path / f"j{tag}.f32"),
                rerank=JRerank(**rerank), **kw)
    tindex = convert.ivf_index(np.asarray(small_index.centroids),
                               np.asarray(small_index.postings),
                               np.asarray(small_index.posting_ids),
                               device="cpu")
    tp = make_quantized_pipeline(tindex, None, SearchConfig(**cfg),
                                 vectors=x, name=f"t{tag}",
                                 flash_path=str(tmp_path / f"t{tag}.f32"),
                                 rerank=RerankConfig(**rerank), device="cpu",
                                 **kw)
    return jp, tp


def _one(pipe, batch, k=10):
    return pipe.harvest(pipe.dispatch(pipe.prefetch(pipe.plan(batch, k))))


def test_auto_round_first_batch_parity_and_adaptation(small_index,
                                                      small_corpus,
                                                      tmp_path):
    """The reference's auto-round test on the port, beside the reference:
    before any I/O stamp the auto width is the configured one (results
    bit-equal to the static config, and equal to the reference's up to
    ties); the stamped cost then retargets the next batch's width; off
    never adapts."""
    x, q, _ = small_corpus
    b = q[:16].astype(np.float32)
    j_off, off = _switch_pipes(small_index, x, tmp_path, "off",
                               dict(round_size=8, auto_round=False))
    j_on, on = _switch_pipes(small_index, x, tmp_path, "on",
                             dict(round_size=8, auto_round=True))
    try:
        r_off, r_on = _one(off, b), _one(on, b)
        assert r_on.times.rerank_round_size == 8 == \
            r_off.times.rerank_round_size
        np.testing.assert_array_equal(r_off.ids, r_on.ids)
        np.testing.assert_array_equal(r_off.dists, r_on.dists)
        w_on = _one(j_on, b)
        assert w_on.times.rerank_round_size == 8
        assert_candidates_match(r_on.dists, r_on.ids, w_on.dists, w_on.ids,
                                tol=1e-4)
        learned = on._auto_round
        assert learned is not None and learned >= 16
        assert j_on._auto_round is not None and j_on._auto_round >= 16
        assert off._auto_round is None and j_off._auto_round is None
        r2 = _one(on, b)
        assert r2.times.rerank_round_size == learned != 8
        assert _one(off, b).times.rerank_round_size == 8
    finally:
        for p in (off, on, j_off, j_on):
            p.flash.release()
        off.close()
        on.close()


@pytest.mark.parametrize("max_rounds", [1, 2])
def test_max_rounds_caps_the_rerank_walk(small_index, small_corpus, tmp_path,
                                         max_rounds):
    """``max_rounds`` stops the walk after that many rounds in both
    packages, with the same candidates re-ranked (ids equal up to ties)."""
    x, q, _ = small_corpus
    b = q[:16].astype(np.float32)
    jp, tp = _switch_pipes(small_index, x, tmp_path, f"m{max_rounds}",
                           dict(round_size=8, stable_rounds=4,
                                max_rounds=max_rounds))
    try:
        got, want = _one(tp, b), _one(jp, b)
    finally:
        tp.close()
        tp.flash.release()
        jp.flash.release()
    assert got.times.rerank_rounds == want.times.rerank_rounds == max_rounds
    # the final top-k reads at least k columns (here 10 > one round's 8)
    assert got.times.rerank_cands == want.times.rerank_cands \
        == max(8 * max_rounds, 10)
    assert_candidates_match(got.dists, got.ids, want.dists, want.ids,
                            tol=1e-4)


@pytest.mark.parametrize("proxy", [True, False])
def test_quality_proxy_switch_matches_the_reference(small_index,
                                                    small_corpus, tmp_path,
                                                    proxy):
    """``quality_proxy=False`` drops the per-query proxy and nothing else;
    on, the port's proxy equals the reference's wherever the ids agree."""
    x, q, _ = small_corpus
    b = q[:16].astype(np.float32)
    jp, tp = _switch_pipes(small_index, x, tmp_path, f"p{proxy}",
                           dict(round_size=64), quality_proxy=proxy)
    try:
        got, want = _one(tp, b), _one(jp, b)
    finally:
        tp.close()
        tp.flash.release()
        jp.flash.release()
    assert (got.quality is None) == (want.quality is None) == (not proxy)
    assert_candidates_match(got.dists, got.ids, want.dists, want.ids,
                            tol=1e-4)
    if proxy:
        same = (got.ids == want.ids).all(axis=1)
        np.testing.assert_array_equal(got.quality[same],
                                      np.asarray(want.quality)[same])


def test_warmup_max_rows_pads_the_union_and_changes_nothing(
        small_index, small_corpus, tmp_path):
    """``warmup(max_rows=)`` adds one scan a batch size over a union padded
    to max_rows (rounded to row_bucket); the reference accepts the same
    switch; None is the plain warmup; results afterwards are the same."""
    x, q, _ = small_corpus
    b = q[:16].astype(np.float32)
    jp, tp = _switch_pipes(small_index, x, tmp_path, "w",
                           dict(round_size=64), row_bucket=32)
    try:
        assert jp.warmup(batch_sizes=(16,), max_rows=64) >= 1
        before = _one(tp, b)
        assert tp.warmup(batch_sizes=(16,)) == 1
        assert tp.warmup(batch_sizes=(16, 32), max_rows=70) == 4
        rows = [ev.rows for ev in tp.tier.stats.events[-4:]]
        assert rows[1] == rows[3] == 96          # 70 rounded up to 32s
        assert max(rows[0], rows[2]) < 96
        after = _one(tp, b)
    finally:
        tp.close()
        tp.flash.release()
        jp.flash.release()
    np.testing.assert_array_equal(before.ids, after.ids)
    np.testing.assert_array_equal(before.dists, after.dists)
