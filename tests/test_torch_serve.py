"""The port's resident and f32 serve paths against the JAX package on one
index: ``serve_step`` (pruning none/fixed/llsp x fused/legacy x f32/q8, and
the two-level centroid scan), ``serve_leveled``, ``search_flat_quantized``,
the f32 ``TieredPostings`` fetch contract, and the f32 streamed, resident
and reference ``PrefetchPipeline`` modes including ``plan(nprobe_cap=,
routed=)``.

The index and the LLSP models are made once with the port on the CPU
(cheap), then handed to both packages as numpy arrays.  The JAX side runs
its oracles (``use_kernel=False``); the port runs its kernels' plain
versions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_candidates_match, torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.core.search import SearchConfig  # noqa: E402

F32_TOL = 1e-4
Q8_TOL = 1e-3
SERVE = dict(k=10, nprobe_max=16, n_ratio=8)


@pytest.fixture(scope="module")
def case():
    """(JAX index, JAX llsp, port index, port llsp, corpus, queries,
    topk): a 3000 x 16 clustered corpus built by the port on the CPU, with
    closure replicas, dead slots, the q8 payload and an 8-group quantizer
    attached to both indexes."""
    from repro.core.gbdt import GBDTParams as JGBDT
    from repro.core.ivf import IVFIndex as JIndex
    from repro.core.llsp import LLSPParams as JLLSP
    from repro_torch.build.kmeans import balanced_hierarchical_kmeans
    from repro_torch.build.pipeline import train_llsp_for_index
    from repro_torch.core.ivf import IVFIndex, build_postings, \
        make_group_quantizer
    from repro_torch.core.llsp import LLSPConfig
    from repro_torch.core.quantize import attach_quantized
    from repro_torch.core.spann_rules import closure_assign
    from repro_torch.data.synthetic import PAPER_DATASETS, make_queries, \
        make_vectors

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=3000, dim=16,
                               n_modes=12)
    x = make_vectors(spec)
    cents, _ = balanced_hierarchical_kmeans(x, 48, iters=6, device="cpu")
    ca = closure_assign(torch.from_numpy(x), torch.from_numpy(cents),
                        eps=0.2, max_replicas=4).numpy()
    postings, pids = build_postings(x, ca, cents.shape[0], 64)
    gc, gm = make_group_quantizer(cents, 8, device="cpu")
    tindex = attach_quantized(IVFIndex(
        torch.from_numpy(cents), torch.from_numpy(postings),
        torch.from_numpy(pids), group_centroids=torch.from_numpy(gc),
        group_members=torch.from_numpy(gm)))
    q_train, topk = make_queries(spec, 64)
    tllsp = train_llsp_for_index(
        LLSPConfig(levels=(8, 16), n_ratio_features=8, n_trees=20,
                   max_depth=4), tindex, x, q_train, np.minimum(topk, 20))
    jarr = lambda t: jnp.asarray(t.numpy())
    jindex = JIndex(*(None if getattr(tindex, f.name) is None
                      else jarr(getattr(tindex, f.name))
                      for f in dataclasses.fields(tindex)))
    jg = lambda g: JGBDT(**convert.gbdt_arrays(g))
    jllsp = JLLSP(jg(tllsp.router), jg(tllsp.pruners),
                  jnp.asarray(tllsp.levels.numpy()))
    rng = np.random.default_rng(11)
    queries = (x[rng.integers(0, len(x), size=64)]
               + 0.2 * rng.normal(size=(64, x.shape[1]))).astype(np.float32)
    topk = np.full(64, 10, np.int32)
    return jindex, jllsp, tindex, tllsp, x, queries, topk


def _match(got, want, tol, max_flips=0.01):
    """Ids equal up to ties on the queries whose nprobe agrees; at most
    ``max_flips`` of the queries may differ in nprobe (LLSP's hard
    splits)."""
    g_np, w_np = np.asarray(got["nprobe"]), np.asarray(want["nprobe"])
    same = g_np == w_np
    assert (~same).mean() <= max_flips, (~same).sum()
    assert_candidates_match(np.asarray(got["dists"])[same],
                            np.asarray(got["ids"])[same],
                            np.asarray(want["dists"])[same],
                            np.asarray(want["ids"])[same], tol=tol)


@pytest.mark.parametrize("tier", ["f32", "q8"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pruning", ["none", "fixed", "llsp"])
def test_serve_step_matches_jax(case, pruning, fused, tier):
    from repro.core.search import SearchConfig as JCfg
    from repro.core.search import serve_step as jserve
    from repro_torch.core.search import serve_step

    jindex, jllsp, tindex, tllsp, _, queries, topk = case
    kw = dict(SERVE, pruning=pruning, fused_topk=fused, tier=tier)
    want = jserve(jindex, jllsp, jnp.asarray(queries), jnp.asarray(topk),
                  JCfg(**kw, use_kernel=False))
    got = serve_step(tindex, tllsp, torch.from_numpy(queries),
                     torch.from_numpy(topk), SearchConfig(**kw))
    assert got["ids"].shape == (len(queries), 10)
    assert got["nprobe"].dtype == torch.int32
    _match({k: v.numpy() for k, v in got.items()}, want,
           F32_TOL if tier == "f32" else Q8_TOL)


def test_serve_step_two_level_matches_jax(case):
    from repro.core.search import SearchConfig as JCfg
    from repro.core.search import centroid_scan as jscan
    from repro.core.search import serve_step as jserve
    from repro_torch.core.search import centroid_scan, serve_step

    jindex, jllsp, tindex, tllsp, _, queries, topk = case
    kw = dict(SERVE, pruning="none", two_level=True, n_groups_probe=2)
    jcd, jcids = jscan(jindex, jnp.asarray(queries), 40, JCfg(**kw))
    tcd, tcids = centroid_scan(tindex, torch.from_numpy(queries), 40,
                               SearchConfig(**kw))
    np.testing.assert_array_equal(tcids.numpy(), np.asarray(jcids))
    np.testing.assert_allclose(tcd.numpy(), np.asarray(jcd), rtol=1e-5)
    assert (tcids.numpy() == -1).any()             # padded: 2 small groups
    want = jserve(jindex, jllsp, jnp.asarray(queries), jnp.asarray(topk),
                  JCfg(**kw, use_kernel=False))
    got = serve_step(tindex, tllsp, torch.from_numpy(queries),
                     torch.from_numpy(topk), SearchConfig(**kw))
    _match({k: v.numpy() for k, v in got.items()}, want, F32_TOL)


def test_group_quantizer_matches_jax(case):
    from repro.core.ivf import make_group_quantizer as jmake
    from repro_torch.core.ivf import make_group_quantizer

    _, _, tindex, _, _, _, _ = case
    cents = tindex.centroids.numpy()
    jgc, jgm = jmake(cents, 8, seed=3)
    tgc, tgm = make_group_quantizer(cents, 8, seed=3, device="cpu")
    np.testing.assert_array_equal(tgm, jgm)
    np.testing.assert_allclose(tgc, jgc, rtol=1e-5, atol=1e-6)
    jindex = case[0]                       # convert carries the quantizer
    carried = convert.ivf_index(
        np.asarray(jindex.centroids), np.asarray(jindex.postings),
        np.asarray(jindex.posting_ids),
        group_centroids=np.asarray(jindex.group_centroids),
        group_members=np.asarray(jindex.group_members), device="cpu")
    assert torch.equal(carried.group_members, tindex.group_members)
    assert torch.equal(carried.group_centroids, tindex.group_centroids)
    assert carried.group_members.dtype == torch.int32 and carried.q8 is None
    assert tindex.nbytes() == sum(
        t.numel() * t.element_size() for t in
        (tindex.centroids, tindex.postings, tindex.posting_ids,
         tindex.group_centroids, tindex.group_members, tindex.q8,
         tindex.qscale, tindex.qnorm2))


@pytest.mark.parametrize("tier", ["f32", "q8"])
def test_serve_leveled_matches_jax(case, tier):
    from repro.core.search import SearchConfig as JCfg
    from repro.core.search import serve_leveled as jlev
    from repro_torch.core.search import serve_leveled

    jindex, jllsp, tindex, tllsp, _, queries, topk = case
    kw = dict(SERVE, pruning="llsp", tier=tier)
    want = jlev(jindex, jllsp, queries, topk, JCfg(**kw, use_kernel=False),
                pad=16)
    got = serve_leveled(tindex, tllsp, queries, topk, SearchConfig(**kw),
                        pad=16)
    assert (got["levels"] == want["levels"]).mean() >= 0.99
    assert set(np.unique(got["levels"]).tolist()) == {0, 1}  # both levels
    assert (got["nprobe"] <= 16).all()
    _match(got, want, F32_TOL if tier == "f32" else Q8_TOL)


@pytest.mark.parametrize("fused,use_kernel", [(True, False), (True, True),
                                              (False, False)])
def test_search_flat_quantized_matches_jax(case, fused, use_kernel):
    from repro.core.quantize import QuantizedPostings as JQP
    from repro.core.quantize import search_flat_quantized as jflat
    from repro_torch.core.quantize import QuantizedPostings, \
        search_flat_quantized

    jindex, _, tindex, _, _, queries, _ = case
    jqp = JQP(jindex.q8, jindex.qscale, jindex.qnorm2)
    wd, wi = jflat(jindex, jqp, jnp.asarray(queries), 10, 12, fused=fused)
    tqp = QuantizedPostings(tindex.q8, tindex.qscale, tindex.qnorm2)
    gd, gi = search_flat_quantized(tindex, tqp, torch.from_numpy(queries),
                                   10, 12, fused=fused,
                                   use_kernel=use_kernel)
    assert_candidates_match(gd, gi, wd, wi, tol=Q8_TOL)


# -------------------------------------------------------------------------
# the f32 host tier and the pipeline's f32 / resident / reference modes
# -------------------------------------------------------------------------
@pytest.mark.parametrize("bucket,pad_rows", [(1, None), (16, None), (8, 40)])
def test_f32_fetch_contract_matches_reference(case, bucket, pad_rows):
    from repro.storage.host_tier import TieredPostings as JTier
    from repro_torch.storage.host_tier import TieredPostings

    _, _, tindex, _, _, _, _ = case
    post, pids = tindex.postings.numpy(), tindex.posting_ids.numpy()
    rng = np.random.default_rng(bucket)
    cids = rng.integers(-1, post.shape[0], size=(6, 5)).astype(np.int32)
    cids[1] = cids[0]                                 # shared union rows
    mask = rng.random(cids.shape) < 0.7
    jt = JTier(post, pids)
    tt = TieredPostings(post, pids, device="cpu")
    want = jt.fetch(cids, mask, pad_rows=pad_rows, bucket=bucket)
    got = tt.fetch(cids, mask, pad_rows=pad_rows, bucket=bucket)
    u = tt.stats.events[-1].clusters_union
    assert u == jt.stats.events[-1].clusters_union
    assert got.ready is None                          # CPU: no copy stream
    packed, ids, remap = (t.numpy() for t in got.tensors())
    assert packed.shape == np.asarray(want[0]).shape
    np.testing.assert_array_equal(packed[:u], np.asarray(want[0])[:u])
    np.testing.assert_array_equal(ids, np.asarray(want[1]))
    np.testing.assert_array_equal(remap, np.asarray(want[2]))
    assert packed.shape[0] % bucket == 0 and packed.shape[0] >= u + 1
    assert (ids[u:] == -1).all()                      # sentinel + pad rows
    live = mask & (cids >= 0)
    assert (remap[~live] == u).all()                  # masked -> sentinel
    ev = tt.stats.events[-1]
    assert ev.clusters_requested == int(live.sum())
    assert ev.union_bytes == u * tt.cluster_bytes
    assert tt.stats.bytes_streamed == jt.stats.bytes_streamed
    tt.release()
    with pytest.raises(RuntimeError, match="released"):
        tt.fetch(cids, mask)


def _batches(q, size=16):
    return [(q[i:i + size], np.full(len(q[i:i + size]), 10, np.int32))
            for i in range(0, len(q), size)]


def _pipes(case, mode):
    """(JAX pipeline, port pipeline) over the same index in ``mode``:
    "streamed" (f32 tier, kernel), "oracle" (f32 tier, packed-domain
    oracle), "resident" or "reference" (f32 tier, pre-runtime scan)."""
    from repro.core.search import SearchConfig as JCfg
    from repro.runtime.pipeline import PrefetchPipeline as JPipe
    from repro.storage.host_tier import TieredPostings as JTier
    from repro_torch.runtime.pipeline import PrefetchPipeline
    from repro_torch.storage.host_tier import TieredPostings

    jindex, jllsp, tindex, tllsp, _, _, _ = case
    kw = dict(SERVE, pruning="llsp")
    post, pids = tindex.postings.numpy(), tindex.posting_ids.numpy()
    streamed = mode != "resident"
    jp = JPipe(jindex, jllsp, JCfg(**kw, use_kernel=False),
               JTier(post, pids) if streamed else None)
    tp = PrefetchPipeline(
        tindex, tllsp, SearchConfig(**kw, use_kernel=mode != "oracle"),
        TieredPostings(post, pids, device="cpu") if streamed else None,
        device="cpu")
    return jp, tp


def _concat(out, field):
    return np.concatenate([getattr(o, field) for o in out])


@pytest.mark.parametrize("mode", ["streamed", "oracle", "resident",
                                  "reference"])
def test_f32_pipeline_matches_jax_pipeline(case, mode):
    from repro_torch.runtime.pipeline import inflight_depth, \
        overlap_efficiency

    _, _, _, _, _, queries, _ = case
    jp, tp = _pipes(case, mode)
    batches = _batches(queries[:40])
    try:
        if mode == "reference":
            want = jp.run_sequential(batches, reference=True)
            got = tp.run_sequential(batches, reference=True)
        else:
            want = jp.run_pipelined(batches, depth=2)
            got = tp.run_pipelined(batches, depth=2)
    finally:
        tp.close()
    assert [len(o.ids) for o in got] == [16, 16, 8]
    assert tp.tier_kind == "f32" and not tp.quantized
    assert tp.streamed == (mode != "resident")
    _match({"ids": _concat(got, "ids"), "dists": _concat(got, "dists"),
            "nprobe": _concat(got, "nprobe")},
           {"ids": _concat(want, "ids"), "dists": _concat(want, "dists"),
            "nprobe": _concat(want, "nprobe")}, F32_TOL)
    times = [o.times for o in got]
    assert 0.0 <= overlap_efficiency(times) <= 1.0
    assert 1 <= inflight_depth(times) <= 2
    if mode == "resident":
        assert all(t.rows == 0 for t in times)        # nothing streamed


def test_plan_routed_and_nprobe_cap_match_jax(case):
    _, _, _, _, _, queries, topk = case
    jp, tp = _pipes(case, "streamed")
    q = queries[:21]
    try:
        cids, nprobe = tp.route(q, topk[:21])
        plain = tp.plan(q, topk[:21])
        routed = tp.plan(q, topk[:21], routed=(cids, nprobe))
        cap = np.where(np.arange(21) % 3 == 0, 2, 0).astype(np.int32)
        capped = tp.plan(q, topk[:21], nprobe_cap=cap)
        jcapped = jp.plan(q, topk[:21], nprobe_cap=cap)
        jrouted = jp.plan(q, topk[:21], routed=jp.route(q, topk[:21]))
        with pytest.raises(ValueError, match="reference scan"):
            tq = _pipes(case, "resident")[1]
            try:
                tq.dispatch(tq.prefetch(tq.plan(q, topk[:21])),
                            reference=True)
            finally:
                tq.close()
    finally:
        tp.close()
    assert routed.times.routed and not plain.times.routed
    np.testing.assert_array_equal(routed.cids[:21], plain.cids[:21])
    assert (routed.cids[21:] == -1).all()             # padding rows
    np.testing.assert_array_equal(routed.pmask, plain.pmask)
    np.testing.assert_array_equal(routed.nprobe, plain.nprobe)
    assert routed.nprobe.shape == (32,) and (routed.nprobe[21:] == 0).all()
    assert (capped.nprobe[:21][cap > 0] <= 2).all()
    np.testing.assert_array_equal(capped.nprobe[:21][cap == 0],
                                  plain.nprobe[:21][cap == 0])
    for mine, ref in ((capped, jcapped), (routed, jrouted)):
        same = mine.nprobe == ref.nprobe
        assert (~same).mean() <= 0.05
        np.testing.assert_array_equal(mine.pmask[same], ref.pmask[same])


def test_resident_q8_pipeline_and_warmup(case):
    from repro_torch.runtime.pipeline import PrefetchPipeline

    _, _, tindex, tllsp, _, queries, _ = case
    cfg = SearchConfig(**SERVE, pruning="llsp", tier="q8")
    pipe = PrefetchPipeline(tindex, tllsp, cfg, device="cpu")
    try:
        assert pipe.quantized and pipe.tier_kind == "q8"
        assert not pipe.streamed
        assert pipe.warmup() == 2
        out = pipe.serve_batch(queries[:16], 10)
    finally:
        pipe.close()
    from repro_torch.core.search import serve_step

    want = serve_step(tindex, tllsp, torch.from_numpy(queries[:16]),
                      torch.full((16,), 10, dtype=torch.int32), cfg)
    np.testing.assert_array_equal(out.ids, want["ids"].numpy())
    np.testing.assert_array_equal(out.nprobe, want["nprobe"].numpy())
