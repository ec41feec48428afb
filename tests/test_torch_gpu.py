"""Card-only tests of the port (marker ``gpu``; they skip where there is no
CUDA card).  Each CUDA kernel is held against its plain torch version, a
small build + serve on the card against the same pipeline on the CPU, and
the resident serve path and the unfused build on the card.
This file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The batched k-means K23 is held against its plain version and, bit for
bit, against the per-node CUDA loop (K2, sort, K3) it replaces.  The
recsys family: one train step of each arch on the card against the CPU,
two identical MIND steps bit-equal, a checkpoint of CUDA tensors.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (  # noqa: E402,F401
    NAN_WHERE, assert_candidates_match, cuda, f32_case, grid_points,
    kmeans_batched_case, per_cell_size_bound, plant_nan, q8_case,
    torch_threads,
)

pytestmark = pytest.mark.gpu

Q8_CASES = [  # (C, L, D, B, P, dead, masked, dup, k2)
    (16, 8, 16, 4, 4, 0.0, 0.2, False, 10),
    (32, 16, 32, 6, 8, 0.3, 0.3, True, 10),
    (9, 16, 24, 5, 3, 0.5, 0.5, False, 40),
    (20, 32, 64, 13, 7, 0.1, 0.0, True, 24),
    (300, 128, 128, 32, 16, 0.05, 0.1, False, 24),   # the main path's shape
]


def _dev(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.mark.parametrize("case", Q8_CASES)
def test_q8_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import ivf_scan_q8 as tq8

    c, l, d, b, p, dead, masked, dup, k2 = case
    arrays = _dev(q8_case(c, l, d, b, p, seed=c, dead=dead, masked=masked,
                          dup=dup), cuda)
    gd, gi = tq8.ivf_scan_q8_topk_cuda(*arrays, k2=k2)
    wd, wi = tq8.ivf_scan_q8_topk_plain(*arrays, k2=k2)
    torch.cuda.synchronize()
    assert_candidates_match(gd.cpu(), gi.cpu(), wd.cpu(), wi.cpu(), tol=1e-3)


def _k1_special_case(kind):
    """K1 inputs for one edge of its split plan: "dup_id" gives one id to a
    row of a low and of a high cluster that query 0 probes, so the two
    copies land in different chunks; "masked" masks every probe of query 3;
    "p_limit" gives every query the most probes the kernel takes (256, with
    repeats); "k2_1", "k2_24", "k2_32", "k2_33" and "k2_256" ask for
    candidates in the register buffer (one, some, all its lanes), just
    above it and at the limit; "online" is serve_online's shape (L 128, D
    128, P 256, k2 200), where the dynamic buffer alone fits 48 KB and
    the plan's static arrays push the block over it."""
    if kind == "p_limit":
        return q8_case(300, 16, 32, 5, 256, seed=50, dead=0.1,
                       masked=0.2), 24
    if kind == "online":
        return q8_case(300, 128, 128, 6, 256, seed=53, dead=0.05,
                       masked=0.1), 200
    if kind.startswith("k2_"):
        return q8_case(60, 32, 64, 9, 16, seed=51, dead=0.1,
                       masked=0.1), int(kind[3:])
    arrays = list(q8_case(40, 32, 64, 16, 8, seed=52, dead=0.1, masked=0.1))
    q8, scale, norm2, cents, ids, cids, mask, q = arrays
    if kind == "dup_id":
        cids[0, :2], mask[0, :2] = (1, 38), True
        ids[38, 5] = ids[1, 7] = 123_456
        q[0] = cents[1] + scale[1, 0, 0] * q8[1, 7]   # on the nearer copy
    else:
        mask[3] = False
    return arrays, 24


K1_KINDS = ["dup_id", "masked", "p_limit", "k2_1", "k2_24", "k2_32",
            "k2_33", "k2_256", "online"]


@pytest.mark.parametrize("chunks", [1, 3, "P", None])
@pytest.mark.parametrize("kind", K1_KINDS)
def test_q8_kernel_chunks_match_plain(cuda, kind, chunks):
    """K1 splits each query's plan over ``chunks`` blocks ("P": one a
    probe, None: the card's own count, both within the kernel's limit) and
    merges their partial top-k2: the same candidates as the plain version
    at one chunk and at many."""
    from repro_torch.kernels import ivf_scan_q8 as tq8

    arrays, k2 = _k1_special_case(kind)
    arrays = _dev(arrays, cuda)
    p = arrays[5].shape[1]
    top = tq8._max_chunks(p, k2)
    n = None if chunks is None else min(p if chunks == "P" else chunks, top)
    gd, gi = tq8.ivf_scan_q8_topk_cuda(*arrays, k2=k2, chunks=n)
    wd, wi = tq8.ivf_scan_q8_topk_plain(*arrays, k2=k2)
    torch.cuda.synchronize()
    assert_candidates_match(gd.cpu(), gi.cpu(), wd.cpu(), wi.cpu(), tol=1e-3)
    if kind == "dup_id":
        assert (gi[0].cpu().numpy() == 123_456).sum() == 1
    if kind == "masked":
        assert torch.isinf(gd[3]).all() and (gi[3] == -1).all()


def test_q8_kernel_deterministic_run_to_run(cuda):
    """Two launches on the same inputs give the same bits: the merge's
    order does not depend on which block finished first."""
    from repro_torch.kernels import ivf_scan_q8 as tq8

    arrays = _dev(q8_case(300, 128, 128, 32, 16, seed=53, dead=0.05,
                          masked=0.1, dup=True), cuda)
    a = tq8.ivf_scan_q8_topk_cuda(*arrays, k2=24)
    b = tq8.ivf_scan_q8_topk_cuda(*arrays, k2=24)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_q8_kernel_refuses_what_it_does_not_take(cuda):
    """Too many probes, a chunk count beyond the kernel's limit, int64 cids
    or a mask that is not bool raise ValueError; nothing falls back."""
    from repro_torch.kernels import ivf_scan_q8 as tq8

    arrays = _dev(q8_case(20, 8, 16, 3, 257, seed=54), cuda)
    with pytest.raises(ValueError, match="P=257"):
        tq8.ivf_scan_q8_topk_cuda(*arrays, k2=8)
    arrays = _dev(q8_case(20, 8, 16, 3, 4, seed=55), cuda)
    with pytest.raises(ValueError, match="chunks"):
        tq8.ivf_scan_q8_topk_cuda(*arrays, k2=8, chunks=5)
    bad = list(arrays)
    bad[5] = bad[5].long()
    with pytest.raises(ValueError, match="int32"):
        tq8.ivf_scan_q8_topk_cuda(*bad, k2=8)
    bad = list(arrays)
    bad[6] = bad[6].to(torch.uint8)
    with pytest.raises(ValueError, match="bool"):
        tq8.ivf_scan_q8_topk_cuda(*bad, k2=8)


@pytest.mark.parametrize("n,k,d", [(700, 9, 6), (5000, 8, 128), (64, 40, 3),
                                   (40000, 700, 32)])
def test_kmeans_kernels_bit_equal_on_grid_inputs(cuda, n, k, d):
    from repro_torch.kernels import kmeans_assign as tassign
    from repro_torch.kernels import kmeans_mstep as tmstep

    x, c = _dev(grid_points(n, k, d, seed=n), cuda)
    got = tassign.kmeans_assign_update_cuda(x, c)
    want = tassign.kmeans_assign_update_plain(x, c)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, _, s, cnt = got
    reseed = x[:k].contiguous()
    assert torch.equal(tmstep.kmeans_mstep_cuda(s, cnt, reseed),
                       tmstep.kmeans_mstep_plain(s, cnt, reseed))


@pytest.mark.parametrize("n,k,d,bad", [(1000, 300, 37, None),
                                       (2049, 257, 128, None),
                                       (300, 130, 1024, None),
                                       (1000, 300, 37, "nan"),
                                       (2049, 257, 128, "inf"),
                                       (300, 130, 1024, "inf_and_nan")])
def test_kmeans_assign_ragged_tiles_bit_equal(cuda, n, k, d, bad):
    """K2's 128 x 128 tiles at N and K off the tile, D 37 (one short ring
    stage), D 128 (resident rows) and D 1024 (rows staged in chunks), and a
    non-finite coordinate: every output equal to the plain version's on
    grid inputs, NaN for NaN (the one-hot rule of the sums)."""
    from repro_torch.kernels import kmeans_assign as tassign

    x, c = grid_points(n, k, d, seed=n + d)
    if bad:
        x[n // 3, d // 2] = np.inf if bad.startswith("inf") else np.nan
        if bad == "inf_and_nan":
            x[n // 2, d // 2] = np.nan
    args = _dev((x, c), cuda)
    got = tassign.kmeans_assign_update_cuda(*args)
    want = tassign.kmeans_assign_update_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got[2]).any() == bool(bad)


def test_kmeans_assign_deterministic_run_to_run(cuda):
    from repro_torch.kernels import kmeans_assign as tassign

    rng = np.random.default_rng(0)
    x, c = _dev((rng.normal(size=(30000, 64)).astype(np.float32),
                 rng.normal(size=(300, 64)).astype(np.float32)), cuda)
    first = tassign.kmeans_assign_update_cuda(x, c)
    for _ in range(3):
        for a, b in zip(first, tassign.kmeans_assign_update_cuda(x, c)):
            assert torch.equal(a, b)


def test_small_build_and_serve_on_card_match_cpu(cuda, tmp_path):
    from repro_torch.build.pipeline import BuildConfig, build_index, \
        index_content_hash
    from repro_torch.core.llsp import LLSPConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.synthetic import PAPER_DATASETS, make_queries, \
        make_vectors
    from repro_torch.kernels.cuda_lib import LAUNCHES
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=20000, dim=32)
    x = make_vectors(spec)
    q, topk = make_queries(spec, 128)
    cfg = BuildConfig(max_cluster_size=48, cluster_len=64,
                      coarse_per_task=5000,
                      llsp=LLSPConfig(levels=(8, 16), n_ratio_features=8,
                                      n_trees=20, max_depth=4))
    LAUNCHES.reset()
    idx, llsp, _ = build_index(x, cfg, str(tmp_path / "a"), queries=q,
                               query_topk=np.minimum(topk, 20), device=cuda)
    counts = LAUNCHES.snapshot()
    # the splitter runs on K23; enforce_size_bound's reassignments on K2
    assert counts["kmeans_batched"] > 0 and counts["kmeans_assign_update"] > 0
    again, _, _ = build_index(x, cfg, str(tmp_path / "b"), device=cuda)
    assert index_content_hash(again) == index_content_hash(idx)
    scfg = SearchConfig(k=10, nprobe_max=16, pruning="llsp", n_ratio=8)
    batches = [(q[i:i + 32], np.full(32, 10, np.int32))
               for i in range(0, 128, 32)]
    outs = {}
    for dev in (cuda, "cpu"):
        pipe = make_quantized_pipeline(idx, llsp, scfg, vectors=x,
                                       flash_path=str(tmp_path / f"{dev}.f"),
                                       device=dev)
        LAUNCHES.reset()
        try:
            outs[str(dev)] = pipe.run_pipelined(batches, depth=2)
        finally:
            pipe.close()
            pipe.flash.release()
        if dev == cuda:
            assert LAUNCHES.snapshot()["ivf_scan_q8_topk"] == len(batches)
    g, c = outs[str(cuda)], outs["cpu"]
    g_np = np.concatenate([o.nprobe for o in g])
    c_np = np.concatenate([o.nprobe for o in c])
    same = g_np == c_np
    assert (~same).mean() <= 0.02
    assert_candidates_match(np.concatenate([o.dists for o in g])[same],
                            np.concatenate([o.ids for o in g])[same],
                            np.concatenate([o.dists for o in c])[same],
                            np.concatenate([o.ids for o in c])[same],
                            tol=1e-5)


def test_traced_build_and_serve_on_card_stamp_their_steps(cuda, tmp_path):
    """A traced build on the card nests its spans with a K23 span a
    lockstep step; served batches stamp the gather's steps in order and the
    scan's device time (CUDA events), placed inside the host's scan
    window, for the streamed q8 tier and the resident f32 index."""
    from repro_torch.build.pipeline import BuildConfig, build_index
    from repro_torch.core.llsp import LLSPConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.synthetic import PAPER_DATASETS, make_queries, \
        make_vectors
    from repro_torch.obs import Observability, check_well_nested
    from repro_torch.runtime.pipeline import PrefetchPipeline, \
        make_quantized_pipeline

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=20000, dim=32)
    x = make_vectors(spec)
    q, topk = make_queries(spec, 128)
    obs = Observability(1.0)
    cfg = BuildConfig(max_cluster_size=48, cluster_len=64,
                      coarse_per_task=5000,
                      llsp=LLSPConfig(levels=(8, 16), n_ratio_features=8,
                                      n_trees=20, max_depth=4))
    idx, llsp, report = build_index(x, cfg, str(tmp_path / "b"), queries=q,
                                    query_topk=np.minimum(topk, 20),
                                    device=cuda, obs=obs)
    names = [e[1] for e in obs.trace.snapshot() if e[0] == "X"]
    assert names.count("stage1.k23") == sum(
        st.steps for st in report.stage1_split) > 0
    assert names.count("shard.h2d") == len(report.shard_stamps)
    assert check_well_nested(obs.trace.export()["traceEvents"]) == []
    scfg = SearchConfig(k=10, nprobe_max=16, pruning="llsp", n_ratio=8)
    batches = [(q[i:i + 32], np.full(32, 10, np.int32))
               for i in range(0, 128, 32)]
    q8 = make_quantized_pipeline(idx, llsp, scfg, vectors=x,
                                 flash_path=str(tmp_path / "f"), device=cuda)
    resident = PrefetchPipeline(idx, llsp, scfg, device=cuda)
    try:
        for pipe in (q8, resident):
            for res in pipe.run_pipelined(batches, depth=2):
                t = res.times
                window_ms = 1e3 * (t.scan_done - t.scan_dispatch)
                assert 0.0 < t.scan_device_ms <= window_ms + 0.5
                # the events place the scan inside the host's scan window
                assert t.scan_dispatch <= t.scan_device_start
                assert t.scan_device_start + 1e-3 * t.scan_device_ms \
                    <= t.scan_done + 5e-4
                assert t.plan_start <= t.plan_wait_start \
                    < t.plan_wait_end <= t.plan_end
                if pipe is q8:
                    assert t.gather_start < t.union_end < t.alloc_end \
                        < t.gather_end < t.stream_end
                    assert t.gather_cpu_s >= 0.0   # in scheduler ticks
                    assert 0.0 < t.rerank_read_wait_s \
                        <= t.rerank_end - t.rerank_start
    finally:
        q8.close()
        q8.flash.release()
        resident.close()


F32_CASES = [  # (C, L, D, B, P, dead, masked, dup, nan_dead, k2, dup_ids)
    (16, 8, 16, 8, 4, 0.0, 0.2, False, False, 10, False),
    (32, 16, 32, 6, 8, 0.3, 0.3, True, True, 10, False),  # ragged B, NaN dead
    (9, 16, 24, 5, 3, 0.5, 0.5, False, True, 40, False),  # k2 > live rows
    (20, 64, 1024, 3, 4, 0.1, 0.0, True, False, 256, False),  # D 1024, k2 256
    (300, 128, 128, 32, 16, 0.05, 0.1, False, True, 24, False),  # main shape
    # the GIST bulk shape with a cut batch: ids repeated across clusters
    (2000, 128, 960, 512, 256, 0.25, 0.1, True, True, 24, True),
]


def _b2_plain(arrays, k2, step=32):
    """B2's plain version over slices of ``step`` queries (a query's result
    does not depend on the others): its (B/8, 8 P, L, D) gather is 64 GB at
    the cut GIST shape, 4 GB a slice."""
    from repro_torch.kernels import ivf_scan as tscan

    post, ids, cids, mask, q = arrays
    outs = [tscan.ivf_scan_topk_plain(post, ids, cids[i:i + step],
                                      mask[i:i + step], q[i:i + step], k2=k2)
            for i in range(0, q.shape[0], step)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


@pytest.mark.parametrize("design", ["by_tile", "by_cluster"])
@pytest.mark.parametrize("case", F32_CASES)
def test_f32_topk_kernel_matches_plain(cuda, case, design):
    """B2 in each design the wrapper can pick (forced by its test hook)
    against its plain version."""
    from repro_torch.kernels import ivf_scan as tscan

    c, l, d, b, p, dead, masked, dup, nan_dead, k2, dup_ids = case
    arrays = _dev(f32_case(c, l, d, b, p, seed=c, dead=dead, masked=masked,
                           dup=dup, nan_dead=nan_dead, dup_ids=dup_ids),
                  cuda)
    gd, gi = tscan.ivf_scan_topk_cuda(*arrays, k2=k2, design=design)
    wd, wi = _b2_plain(arrays, k2)
    torch.cuda.synchronize()
    assert not torch.isnan(gd).any()
    # the cut GIST shape: 32k candidates a query at distances near 1,800
    assert_candidates_match(gd.cpu(), gi.cpu(), wd.cpu(), wi.cpu(), tol=1e-4,
                            boundary=c >= 2000)


def test_f32_topk_designs_agree_bit_for_bit_and_count_their_launches(cuda):
    """The two designs take each dot, norm and distance in the same order,
    so they give the same bits; two by-cluster launches give the same bits
    (the merge's order depends on the data alone); each call counts one
    ``ivf_scan_topk`` launch and one of its design."""
    from repro_torch.kernels import ivf_scan as tscan
    from repro_torch.kernels.cuda_lib import LAUNCHES

    arrays = _dev(f32_case(300, 128, 128, 64, 32, seed=7, dead=0.1,
                           masked=0.1, dup_ids=True), cuda)
    before = LAUNCHES.snapshot()
    a = tscan.ivf_scan_topk_cuda(*arrays, k2=24, design="by_cluster")
    b = tscan.ivf_scan_topk_cuda(*arrays, k2=24, design="by_cluster")
    t = tscan.ivf_scan_topk_cuda(*arrays, k2=24, design="by_tile")
    torch.cuda.synchronize()
    after = LAUNCHES.snapshot()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], t[0]) and torch.equal(a[1], t[1])
    assert after["ivf_scan_topk"] - before["ivf_scan_topk"] == 3
    assert after["ivf_scan_topk.by_cluster"] \
        - before["ivf_scan_topk.by_cluster"] == 2
    assert after["ivf_scan_topk.by_tile"] - before["ivf_scan_topk.by_tile"] \
        == 1


def test_f32_topk_wrapper_picks_its_design_from_the_shapes(cuda):
    """Without the hook the wrapper launches the design that b2_design
    names for the batch's (B, P, R, D, k2)."""
    from repro_torch.kernels import ivf_scan as tscan
    from repro_torch.kernels.cuda_lib import LAUNCHES

    for r, b, p in ((1024, 32, 16), (64, 512, 64)):
        arrays = _dev(f32_case(r, 128, 128, b, p, seed=r, dead=0.1), cuda)
        want = tscan.b2_design(b, p, r, 128, 128, 24)
        before = LAUNCHES.snapshot()[f"ivf_scan_topk.{want}"]
        tscan.ivf_scan_topk_cuda(*arrays, k2=24)
        assert LAUNCHES.snapshot()[f"ivf_scan_topk.{want}"] == before + 1


def _b2_special_case(kind):
    """B2 inputs for one merge edge: "dup_id" gives one id to a row of a
    low and of a high cluster that query 0 probes, so the two copies land
    in different chunks (by tile) or slots (by cluster); "masked" masks
    every probe of query 3; "k2_big" asks for more candidates than the live
    rows hold."""
    if kind == "k2_big":
        return f32_case(9, 16, 24, 5, 3, seed=40, dead=0.5, masked=0.5), 40
    post, ids, cids, mask, q = f32_case(40, 32, 64, 16, 8, seed=41,
                                        dead=0.1, masked=0.1)
    if kind == "dup_id":
        cids[0, :2], mask[0, :2] = (1, 38), True
        ids[38, 5] = ids[1, 7] = 123_456
        post[38, 5] = q[0] + 0.01                   # the nearer copy
    else:
        mask[3] = False
    return (post, ids, cids, mask, q), 24


@pytest.mark.parametrize("design,chunks", [
    ("by_tile", 1), ("by_tile", 2), ("by_tile", 7), ("by_tile", None),
    ("by_tile", 64), ("by_cluster", None)])
@pytest.mark.parametrize("kind", ["dup_id", "masked", "k2_big"])
def test_f32_topk_kernel_chunks_match_plain(cuda, kind, design, chunks):
    """B2 by tile splits a tile's plan over ``chunks`` blocks (None: the
    card's own count), by cluster a query's slots over their clusters'
    blocks, and merges their partial top-k2: the same candidates as the
    plain version in each."""
    from repro_torch.kernels import ivf_scan as tscan

    arrays, k2 = _b2_special_case(kind)
    arrays = _dev(arrays, cuda)
    s_len = 8 * arrays[2].shape[1]
    n = None if chunks is None else min(chunks, s_len)
    gd, gi = tscan.ivf_scan_topk_cuda(*arrays, k2=k2, chunks=n,
                                      design=design)
    wd, wi = tscan.ivf_scan_topk_plain(*arrays, k2=k2)
    torch.cuda.synchronize()
    assert_candidates_match(gd.cpu(), gi.cpu(), wd.cpu(), wi.cpu(), tol=1e-4)
    if kind == "dup_id":
        row = gi[0].cpu().numpy()
        assert (row == 123_456).sum() == 1
    if kind == "masked":
        assert torch.isinf(gd[3]).all() and (gi[3] == -1).all()


@pytest.mark.parametrize("where", NAN_WHERE)
@pytest.mark.parametrize("kernel", ["ivf_scan_topk", "ivf_scan_q8_topk"])
def test_fused_scans_follow_the_reference_on_a_nan_distance(cuda, kernel,
                                                            where):
    """A NaN distance of a live row empties the query's candidates at that
    slot; later slots refill them (the reference's _extract_topk, which
    the plain versions follow): B2 and K1 at one chunk and at many, so the
    NaN falls in the first and in the last chunk, and B2 by cluster, where
    it falls in the query's first or last slot."""
    from repro_torch.kernels import ivf_scan as tscan
    from repro_torch.kernels import ivf_scan_q8 as tq8

    if kernel == "ivf_scan_topk":
        arrays = f32_case(40, 32, 64, 16, 8, seed=42, dead=0.1, masked=0.1)
        post, ids, cids, mask, _ = arrays
        plant_nan(post, ids, cids, mask, where, q=1)
        arrays = _dev(arrays, cuda)
        want = tscan.ivf_scan_topk_plain(*arrays, k2=24)
        gots = [tscan.ivf_scan_topk_cuda(*arrays, k2=24, chunks=n,
                                          design="by_tile")
                for n in (1, 5, None)]
        gots.append(tscan.ivf_scan_topk_cuda(*arrays, k2=24,
                                             design="by_cluster"))
        tol = 1e-4
    else:
        arrays = q8_case(40, 32, 64, 16, 8, seed=43, dead=0.1, masked=0.1)
        plant_nan(arrays[2], arrays[4], arrays[5], arrays[6], where, q=1)
        arrays = _dev(arrays, cuda)
        want = tq8.ivf_scan_q8_topk_plain(*arrays, k2=24)
        gots = [tq8.ivf_scan_q8_topk_cuda(*arrays, k2=24, chunks=n)
                for n in (1, 3, 8, None)]
        tol = 1e-3
    torch.cuda.synchronize()
    for gd, gi in gots:
        assert not torch.isnan(gd).any()
        assert_candidates_match(gd.cpu(), gi.cpu(), want[0].cpu(),
                                want[1].cpu(), tol=tol)


@pytest.mark.parametrize("c,l,d,b,p,masked", [(10, 8, 12, 5, 4, 0.3),
                                              (300, 128, 128, 32, 16, 0.2)])
def test_legacy_scan_kernel_matches_plain(cuda, c, l, d, b, p, masked):
    from repro_torch.kernels import ivf_scan as tscan

    post, _, cids, mask, q = _dev(f32_case(c, l, d, b, p, seed=d,
                                           masked=masked), cuda)
    got = tscan.ivf_scan_cuda(post, cids, mask, q)
    want = tscan.ivf_scan_plain(post, cids, mask, q)
    torch.cuda.synchronize()
    assert torch.isinf(got[~mask]).all() and (got[~mask] > 0).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n,m,d", [(2049, 65, 3), (1, 1, 5), (100, 300, 20),
                                   (5000, 700, 128)])
def test_pairwise_l2_kernel_matches_plain(cuda, n, m, d):
    from repro_torch.kernels import pairwise_l2 as tpw

    a, b = _dev(grid_points(n, m, d, seed=n), cuda)    # exact in f32
    assert torch.equal(tpw.pairwise_l2_cuda(a, b), tpw.pairwise_l2_plain(a, b))
    rng = np.random.default_rng(n)
    a, b = _dev((rng.normal(size=(n, d)).astype(np.float32),
                 rng.normal(size=(m, d)).astype(np.float32)), cuda)
    torch.testing.assert_close(tpw.pairwise_l2_cuda(a, b),
                               tpw.pairwise_l2_plain(a, b), rtol=1e-4,
                               atol=1e-4)


B5_EDGES = (1, 2, 8, 127, 128, 129)   # around the narrow and wide tiles


def _b5_variants(m, d):
    from repro_torch.kernels import pairwise_l2 as tpw

    return [v for v in ("narrow", "wide")
            if v == "wide" or tpw.narrow_rows(m, d) >= 1]


@pytest.mark.parametrize("d", [3, 37, 128, 1024])
@pytest.mark.parametrize("n", B5_EDGES)
def test_pairwise_l2_variants_equal_plain_at_tile_edges(cuda, n, d):
    """Every variant that takes the shape, and the wrapper's pick, equal the
    plain version on grid points (exact in f32), for every M of B5_EDGES:
    both sides of the narrow/wide threshold and of the 128-wide tiles."""
    from repro_torch.kernels import pairwise_l2 as tpw

    for m in B5_EDGES + (tpw.NARROW_MAX_M, tpw.NARROW_MAX_M + 1):
        a, b = _dev(grid_points(n, m, d, seed=n * 131 + m + d), cuda)
        want = tpw.pairwise_l2_plain(a, b)
        assert torch.equal(tpw.pairwise_l2_cuda(a, b), want), (n, m, d)
        for variant in _b5_variants(m, d):
            got = tpw.pairwise_l2_cuda(a, b, variant=variant)
            assert torch.equal(got, want), (n, m, d, variant)


@pytest.mark.parametrize("d", [3, 37, 128, 1024])
def test_pairwise_l2_equals_plain_at_the_unfused_builds_largest_shape(cuda,
                                                                      d):
    from repro_torch.kernels import pairwise_l2 as tpw

    a, b = _dev(grid_points(16384, 1929, d, seed=d), cuda)
    assert torch.equal(tpw.pairwise_l2_cuda(a, b),
                       tpw.pairwise_l2_plain(a, b))


@pytest.mark.parametrize("n,m", [(97, 2), (5000, 8), (16384, 1929),
                                 (3000, 300)])
def test_pairwise_l2_argmin_bit_equal_to_kmeans_assign(cuda, n, m):
    """On normal data the argmin and min of B5's distances are K2's assign
    and min_dist bit for bit, in every variant: the unfused and the fused
    E-step agree, so the unfused build hashes as before."""
    from repro_torch.kernels import kmeans_assign as tassign
    from repro_torch.kernels import pairwise_l2 as tpw

    rng = np.random.default_rng(n + m)
    x, c = _dev((rng.normal(size=(n, 128)).astype(np.float32),
                 rng.normal(size=(m, 128)).astype(np.float32)), cuda)
    assign, min_dist = tassign.kmeans_assign_update_cuda(x, c)[:2]
    for variant in _b5_variants(m, 128):
        d = tpw.pairwise_l2_cuda(x, c, variant=variant)
        assert torch.equal(torch.argmin(d, dim=1).to(torch.int32), assign)
        assert torch.equal(torch.min(d, dim=1).values.view(torch.int32),
                           min_dist.view(torch.int32)), variant


def test_pairwise_l2_refuses_a_narrow_shape_that_does_not_fit(cuda):
    from repro_torch.kernels import pairwise_l2 as tpw

    a, b = _dev(grid_points(10, 64, 1024, seed=1), cuda)
    assert tpw.narrow_rows(64, 1024) == 0
    with pytest.raises(ValueError, match="do not fit"):
        tpw.pairwise_l2_cuda(a, b, variant="narrow")
    with pytest.raises(ValueError, match="unknown variant"):
        tpw.pairwise_l2_cuda(a, b, variant="tiled")


@pytest.mark.parametrize("d", [4, 36, 1024])
@pytest.mark.parametrize("l", [1, 33, 129, 1024])
def test_legacy_scan_kernel_at_ring_edges(cuda, l, d):
    """B6a where its ring of row chunks starts, wraps and ends ragged, at a
    D of one float4, of one thread a row and of a warp a row, with cluster
    ids out of range (clamped) and a query with every probe masked."""
    from repro_torch.kernels import ivf_scan as tscan

    post, _, cids, mask, q = f32_case(6, l, d, 5, 4, seed=l + d, masked=0.2)
    cids[0, 1], cids[1, 2] = 9, -5
    mask[0, 1] = mask[1, 2] = True
    mask[3] = False
    post, cids, mask, q = _dev((post, cids, mask, q), cuda)
    got = tscan.ivf_scan_cuda(post, cids, mask, q)
    want = tscan.ivf_scan_plain(post, cids, mask, q)
    torch.cuda.synchronize()
    assert torch.isinf(got[~mask]).all() and (got[~mask] > 0).all()
    assert torch.isfinite(got[mask]).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_unfused_kmeans_assign_on_card_bit_equal_to_cpu(cuda):
    from repro_torch.kernels import ops
    from repro_torch.kernels.cuda_lib import LAUNCHES

    x, c = grid_points(40000, 300, 32, seed=7)
    LAUNCHES.reset()
    ga, gmd = ops.kmeans_assign(*_dev((x, c), cuda), chunk=16384)
    assert LAUNCHES.snapshot()["pairwise_l2"] == 3
    ca, cmd = ops.kmeans_assign(*_dev((x, c), "cpu"), chunk=16384)
    assert torch.equal(ga.cpu(), ca) and torch.equal(gmd.cpu(), cmd)


@pytest.mark.parametrize("fused,tier", [(True, "f32"), (False, "f32"),
                                        (True, "q8")])
def test_resident_serve_step_on_card_matches_cpu(cuda, fused, tier):
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.core.quantize import attach_quantized
    from repro_torch.core.search import SearchConfig, serve_step
    from repro_torch.kernels.cuda_lib import LAUNCHES

    post, ids, _, _, q = f32_case(200, 64, 32, 40, 1, seed=3, dead=0.1)
    cents = post.mean(axis=1)
    index = attach_quantized(IVFIndex(*(torch.from_numpy(a) for a in
                                        (cents, post, ids))))
    cfg = SearchConfig(k=10, nprobe_max=12, fused_topk=fused, tier=tier)
    tk = torch.full((40,), 10, dtype=torch.int32)
    LAUNCHES.reset()
    got = serve_step(index.to(cuda), None, torch.from_numpy(q).to(cuda),
                     tk.to(cuda), cfg)
    name = {("f32", True): "ivf_scan_topk", ("f32", False): "ivf_scan",
            ("q8", True): "ivf_scan_q8_topk"}[(tier, fused)]
    assert LAUNCHES.snapshot()[name] == 1
    want = serve_step(index, None, torch.from_numpy(q), tk, cfg)
    assert_candidates_match(got["dists"].cpu(), got["ids"].cpu(),
                            want["dists"], want["ids"],
                            tol=1e-4 if tier == "f32" else 1e-3)


def test_unfused_build_on_card_launches_pairwise_l2(cuda, tmp_path):
    from repro_torch.build.pipeline import BuildConfig, build_index, \
        index_content_hash
    from repro_torch.data.synthetic import PAPER_DATASETS, make_vectors
    from repro_torch.kernels.cuda_lib import LAUNCHES

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=8000, dim=32)
    x = make_vectors(spec)
    cfg = BuildConfig(max_cluster_size=48, cluster_len=64,
                      coarse_per_task=4000, fused_assign=False)
    LAUNCHES.reset()
    idx, _, rep = build_index(x, cfg, str(tmp_path / "a"), device=cuda)
    counts = LAUNCHES.snapshot()
    assert counts["pairwise_l2"] > 0 and counts["kmeans_assign_update"] == 0
    again, _, _ = build_index(x, cfg, str(tmp_path / "b"), device=cuda)
    assert index_content_hash(again) == index_content_hash(idx)
    assert rep.replication >= 1.0


def _cmajor_case(c, l, d, b, a_n, seed, nan_row=False, sel=0.6):
    """Postings, an active-cluster list with duplicates and out-of-range
    ids, a selection mask (each pair selected with probability ``sel``) and
    queries; ``nan_row`` puts a NaN in one row of an active cluster."""
    rng = np.random.default_rng(seed)
    post, _, _, _, q = f32_case(c, l, d, b, 1, seed=seed)
    active = rng.integers(-2, c + 2, size=a_n).astype(np.int32)
    active[-1] = active[0]
    qsel = rng.random((a_n, b)) < sel
    if nan_row:
        post[np.clip(active[0], 0, c - 1), l // 2, d // 3] = np.nan
        qsel[0] = True
    return post, active, qsel, q


def _check_clustermajor(cuda, arrays):
    from repro_torch.kernels import ivf_scan as tscan

    arrays = _dev(arrays, cuda)
    got = tscan.ivf_scan_clustermajor_cuda(*arrays)
    want = tscan.ivf_scan_clustermajor_plain(*arrays)
    torch.cuda.synchronize()
    qsel = arrays[2]
    assert (got.permute(0, 2, 1)[~qsel] == float("inf")).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               equal_nan=True)
    return got


CMAJOR_CASES = [  # (C, L, D, B, A, nan_row)
    (16, 8, 16, 4, 6, False),
    (32, 16, 32, 13, 12, True),          # ragged B, NaN in a live row
    (20, 40, 1024, 5, 7, False),         # D 1024: several D slices
    (600, 128, 128, 32, 458, False),     # the union of one streamed batch
]


@pytest.mark.parametrize("case", CMAJOR_CASES)
def test_clustermajor_kernel_matches_plain(cuda, case):
    c, l, d, b, a_n, nan_row = case
    got = _check_clustermajor(cuda, _cmajor_case(c, l, d, b, a_n, seed=a_n,
                                                 nan_row=nan_row))
    assert torch.isnan(got).any() == nan_row


CMAJOR_SELECT = {"none": 0.0, "all": 1.0, "sparse": 0.03}


@pytest.mark.parametrize("sel", sorted(CMAJOR_SELECT))
@pytest.mark.parametrize("d", [3, 37, 128, 1024])
@pytest.mark.parametrize("l", [1, 33, 129])
@pytest.mark.parametrize("b", [1, 31, 32, 33, 100])
def test_clustermajor_kernel_at_tile_edges(cuda, b, l, d, sel):
    """B ragged against the 32-lane ballot and the 32-column blocks, L
    against the 32-row ring chunks, D against 16-byte copies (3, 37: 4-byte
    copies into zero-padded rows) and the 128-dimension slices, and a
    selection that is empty, full (every chunk of 32 queries) or sparse."""
    arrays = _cmajor_case(9, l, d, b, 6, seed=b + l + d,
                          sel=CMAJOR_SELECT[sel])
    got = _check_clustermajor(cuda, arrays)
    if sel == "none":
        assert (got == float("inf")).all()


def test_clustermajor_kernel_keeps_nan_only_where_selected(cuda):
    """A NaN row that some queries select and others do not: NaN where
    selected, +inf where not, as the reference's jnp.where gives."""
    post, active, qsel, q = _cmajor_case(12, 40, 37, 70, 5, seed=8)
    active[0] = 3
    post[3, 17, 5] = np.nan
    qsel[0] = np.arange(70) % 3 == 0
    got = _check_clustermajor(cuda, (post, active, qsel, q))
    row = got[0, 17].cpu().numpy()
    assert np.isnan(row[qsel[0]]).all()
    assert (row[~qsel[0]] == np.inf).all()
    assert torch.isfinite(got[0, :17]).any()


def test_clustermajor_kernel_deterministic_run_to_run(cuda):
    from repro_torch.kernels import ivf_scan as tscan

    arrays = _dev(_cmajor_case(300, 128, 128, 100, 200, seed=4, sel=0.3),
                  cuda)
    first = tscan.ivf_scan_clustermajor_cuda(*arrays)
    again = tscan.ivf_scan_clustermajor_cuda(*arrays)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def _q8_legacy_case(c, l, d, b, p, masked, nan_norm, seed):
    q8, scale, norm2, cents, _, cids, mask, q = q8_case(
        c, l, d, b, p, seed=seed, dead=0.2, masked=masked, dup=True)
    cids[0, -1] = c + 5                   # out of range: clamped to C - 1
    cids[-1, 0] = -3                      # out of range: clamped to 0
    if nan_norm:
        mask[1, 2] = True
        norm2[cids[1, 2], l // 2] = np.nan
    return q8, scale, norm2, cents, cids, mask, q


def _vec4_view(q8):
    """A copy of ``q8`` 4 bytes past a 16-byte boundary: a contiguous view
    that ``ivf_scan_q8_variant`` sends to the vec4 variant at any shape."""
    buf = torch.empty(q8.numel() + 16, dtype=torch.int8, device=q8.device)
    start = (4 - buf.data_ptr()) % 16
    view = buf[start:start + q8.numel()].view(q8.shape)
    view.copy_(q8)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _check_q8_legacy(arrays):
    from repro_torch.kernels import ivf_scan_q8 as tq8

    got = tq8.ivf_scan_q8_cuda(*arrays)
    want = tq8.ivf_scan_q8_plain(*arrays)
    torch.cuda.synchronize()
    m = arrays[5]
    assert (got[~m] == float("inf")).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3,
                               equal_nan=True)
    return got


Q8_LEGACY_CASES = [  # (C, L, D, B, P, masked, nan_norm)
    (16, 8, 16, 4, 4, 0.2, False),
    (40, 48, 24, 13, 7, 0.3, True),      # ragged B, NaN in a live norm
    (20, 64, 1024, 3, 4, 0.0, False),    # D 1024
    (300, 128, 128, 32, 16, 0.1, False),  # one resident batch
] + [(12, l, d, 3, 4, 0.3, False)       # every variant's row and batch edges
     for l in (1, 33, 128, 1024) for d in (4, 12, 16, 128, 1024)]


@pytest.mark.parametrize("case", Q8_LEGACY_CASES)
def test_q8_legacy_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import ivf_scan_q8 as tq8

    c, l, d, b, p, masked, nan_norm = case
    arrays = _dev(_q8_legacy_case(*case, seed=c + 1), cuda)
    got = _check_q8_legacy(arrays)
    assert torch.isnan(got).any() == nan_norm
    if tq8.ivf_scan_q8_variant(d, arrays[0].data_ptr()) == "vec16":
        # the other variant takes every shape: the same distances
        vec4 = [_vec4_view(arrays[0]), *arrays[1:]]
        torch.testing.assert_close(_check_q8_legacy(vec4), got,
                                   rtol=1e-4, atol=1e-3, equal_nan=True)


def test_q8_legacy_kernel_on_codes_not_16_byte_aligned(cuda):
    """A q8 view whose base is 4-byte but not 16-byte aligned takes the
    4-byte variant and still matches, as does the aligned original in the
    16-byte one."""
    from repro_torch.kernels import ivf_scan_q8 as tq8

    q8, *rest = _dev(_q8_legacy_case(30, 128, 128, 6, 5, 0.2, False,
                                     seed=3), cuda)
    view = _vec4_view(q8)
    assert tq8.ivf_scan_q8_variant(128, view.data_ptr()) == "vec4"
    assert tq8.ivf_scan_q8_variant(128, q8.data_ptr()) == "vec16"
    got = _check_q8_legacy([view, *rest])
    torch.testing.assert_close(got, _check_q8_legacy([q8, *rest]),
                               rtol=1e-4, atol=1e-3)


def test_q8_legacy_kernel_deterministic_run_to_run(cuda):
    from repro_torch.kernels import ivf_scan_q8 as tq8

    arrays = _dev(_q8_legacy_case(300, 128, 128, 32, 16, 0.1, False,
                                  seed=5), cuda)
    for q8 in (arrays[0], _vec4_view(arrays[0])):  # vec16, then vec4
        first = tq8.ivf_scan_q8_cuda(q8, *arrays[1:])
        again = tq8.ivf_scan_q8_cuda(q8, *arrays[1:])
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.parametrize("kernel", ["ivf_scan", "pairwise_l2"])
def test_legacy_kernels_keep_a_nan_distance(cuda, kernel):
    """A NaN in one live row must come out as NaN, as the reference's
    jnp.maximum(d, 0.0) clamp keeps it (an fmaxf clamp would make it 0,
    the nearest distance there is)."""
    from repro_torch.kernels import ivf_scan as tscan
    from repro_torch.kernels import pairwise_l2 as tpw

    if kernel == "ivf_scan":
        post, _, cids, mask, q = f32_case(12, 16, 32, 6, 4, seed=5,
                                          masked=0.0)
        post[cids[2, 1], 7, 3] = np.nan
        args = _dev((post, cids, mask, q), cuda)
        got = tscan.ivf_scan_cuda(*args)
        want = tscan.ivf_scan_plain(*args)
    else:
        rng = np.random.default_rng(5)
        a = rng.normal(size=(70, 24)).astype(np.float32)
        b = rng.normal(size=(90, 24)).astype(np.float32)
        a[33, 4] = np.nan
        args = _dev((a, b), cuda)
        got = tpw.pairwise_l2_cuda(*args)
        want = tpw.pairwise_l2_plain(*args)
    torch.cuda.synchronize()
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               equal_nan=True)


ITERS = 5


def _per_node_cuda(xd, pts, offs, k, init, iters):
    """The per-node loop the splitter ran before K23: K2, a stable sort and
    K3 on each sub-problem in turn, on the card."""
    from repro_torch.kernels import kmeans_assign as tassign
    from repro_torch.kernels import kmeans_mstep as tmstep
    from repro_torch.kernels.kmeans_batched import lloyd

    outs = []
    for s in range(k.shape[0]):
        lo, hi, ks = int(offs[s]), int(offs[s + 1]), int(k[s])
        xs = xd[pts[lo:hi].to(xd.device).long()].contiguous()
        c0 = xs[init[s, :ks].to(xd.device).long()].contiguous()
        outs.append(lloyd(xs, c0, iters, tassign.kmeans_assign_update_cuda,
                          tmstep.kmeans_mstep_cuda))
    return outs


@pytest.mark.parametrize("kind,iters", [("grid", 1), ("gaussian", ITERS)])
def test_kmeans_batched_matches_plain(cuda, kind, iters):
    """Grid inputs are exact while the centroids are integers, i.e. through
    the first E-step and M-step (the means are IEEE divisions on both
    sides): bit-equal.  Later iterations' distances round differently from
    the plain version's matrix product, so several iterations are held to
    the tolerance on Gaussian inputs."""
    from repro_torch.kernels import kmeans_batched as tb

    x, pts, offs, k, init, _ = kmeans_batched_case(kind, d=24, seed=5)
    xd = x.to(cuda)
    got = tb.kmeans_batched_cuda(xd, pts, offs, k, init, iters)
    want = tb.kmeans_batched_plain(xd, pts, offs, k, init, iters)
    torch.cuda.synchronize()
    if kind == "grid":
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        return
    assert (got[0] == want[0]).float().mean() >= 0.99
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [6, 37, 128, 200, 1024])
def test_kmeans_batched_bit_equal_to_per_node_cuda_loop(cuda, d):
    """Every tile height (64 rows at D 128, 32 at 200, 8 at 1024) and both
    copy widths (16-byte cp.async at D % 4 == 0, 4-byte otherwise)."""
    from repro_torch.kernels import kmeans_batched as tb

    x, pts, offs, k, init, _ = kmeans_batched_case("gaussian", d=d, seed=d)
    xd = x.to(cuda)
    a, md, cents, counts = tb.kmeans_batched_cuda(xd, pts, offs, k, init,
                                                  ITERS)
    for s, (c, pa, pmd, pcnt) in enumerate(
            _per_node_cuda(xd, pts, offs, k, init, ITERS)):
        lo, hi, ks = int(offs[s]), int(offs[s + 1]), int(k[s])
        assert torch.equal(a[lo:hi], pa)
        assert torch.equal(md[lo:hi], pmd)
        assert torch.equal(cents[s, :ks], c)
        assert torch.equal(counts[s, :ks], pcnt)
        assert not cents[s, ks:].any() and not counts[s, ks:].any()


def test_kmeans_batched_deterministic_run_to_run(cuda):
    from repro_torch.kernels import kmeans_batched as tb

    x, pts, offs, k, init, _ = kmeans_batched_case("gaussian", d=128, seed=9)
    xd = x.to(cuda)
    first = tb.kmeans_batched_cuda(xd, pts, offs, k, init, 8)
    for _ in range(3):
        for u, v in zip(first, tb.kmeans_batched_cuda(xd, pts, offs, k, init,
                                                      8)):
            assert torch.equal(u, v)


def test_kmeans_batched_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import kmeans_batched as tb

    x, pts, offs, k, init, _ = kmeans_batched_case("grid", d=8, seed=1)
    xd = x.to(cuda)
    bad_k = k.clone()
    bad_k[1] = 17
    bad_init = init.clone()
    bad_init[0, 0] = 50                              # sub-problem 0 has 50
    bad_pts = pts.clone()
    bad_pts[3] = x.shape[0]
    for args, msg in (((xd, pts, offs, bad_k, init), "1 <= k"),
                      ((xd, pts, offs, k, bad_init), "init out of range"),
                      ((xd, bad_pts, offs, k, init), "pts out of range"),
                      ((xd, pts.to(cuda), offs, k, init), "host int32"),
                      ((torch.zeros((4, 1025), device=cuda), pts[:4],
                        torch.tensor([0, 4]).int(), k[:1], init[:1]),
                       "D=1025")):
        with pytest.raises(ValueError, match=msg):
            tb.kmeans_batched_cuda(*args, ITERS)


def test_lockstep_splitter_on_card_equals_per_node_splitter(cuda):
    from repro_torch.build.kmeans import SplitStats, \
        balanced_hierarchical_kmeans, balanced_hierarchical_kmeans_many
    from repro_torch.kernels.cuda_lib import LAUNCHES

    rng = np.random.default_rng(4)
    chunks = [rng.normal(size=(n, 32)).astype(np.float32)
              for n in (1500, 900, 40, 1200)]
    chunks.append(np.repeat(chunks[0][:1], 300, axis=0))   # median splits
    seeds = [1000 * i for i in range(len(chunks))]
    st = SplitStats()
    LAUNCHES.reset()
    got = balanced_hierarchical_kmeans_many(chunks, seeds, 64, device=cuda,
                                            stats=st)
    counts = LAUNCHES.snapshot()
    assert counts["kmeans_batched"] == st.steps == len(st.kernel_ms)
    assert counts["kmeans_assign_update"] == counts["kmeans_mstep"] == 0
    for chunk, seed, (gc, ga) in zip(chunks, seeds, got):
        wc, wa = balanced_hierarchical_kmeans(chunk, 64, seed=seed,
                                              device=cuda)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(ga, wa)


def test_size_bound_on_card_equals_per_cell_2means(cuda):
    """``enforce_size_bound`` runs each round's 2-means in one K23 launch;
    the per-cell loop (fused ``kmeans``: K2, sort, K3) gives the same
    centroids bit for bit."""
    from repro_torch.build.kmeans import enforce_size_bound
    from repro_torch.kernels.cuda_lib import LAUNCHES

    rng = np.random.default_rng(8)
    x = rng.normal(size=(20000, 32)).astype(np.float32)
    start = x[:6].copy()
    LAUNCHES.reset()
    got = enforce_size_bound(x, start, 300, seed=2, device=cuda)
    counts = LAUNCHES.snapshot()
    assert counts["kmeans_mstep"] == 0
    assert counts["kmeans_batched"] == counts["kmeans_assign_update"] - 1
    np.testing.assert_array_equal(
        got, per_cell_size_bound(x, start, 300, seed=2, device=cuda))


@pytest.mark.parametrize("kernel", ["kmeans_assign_update", "kmeans_batched"])
def test_kmeans_kernels_keep_a_nan_distance(cuda, kernel):
    """A NaN row and a NaN centroid: the NaN distance wins the argmin (the
    first NaN first) and stays NaN in min_dist, as in the plain versions
    (torch.argmin, the reference's jnp.argmin and jnp.maximum clamp); an
    fmaxf clamp with a strict < would turn it into 0 and never pick it."""
    from repro_torch.kernels import kmeans_assign as tassign
    from repro_torch.kernels import kmeans_batched as tb

    if kernel == "kmeans_assign_update":
        x, c = grid_points(300, 7, 5, seed=3)
        x[17, 2] = np.nan
        c[4, 1] = np.nan
        args = _dev((x, c), cuda)
        got = tassign.kmeans_assign_update_cuda(*args)
        want = tassign.kmeans_assign_update_plain(*args)
    else:
        x, pts, offs, k, init, _ = kmeans_batched_case("grid", d=5, seed=2)
        # a NaN in an initial centroid of sub-problem 1 and in a plain row
        # of sub-problem 2; one iteration keeps the grid exact
        x[int(pts[int(offs[1]) + int(init[1, 3])]), 1] = float("nan")
        x[int(pts[int(offs[2]) + 7]), 2] = float("nan")
        xd = x.to(cuda)
        got = tb.kmeans_batched_cuda(xd, pts, offs, k, init, 1)
        want = tb.kmeans_batched_plain(xd, pts, offs, k, init, 1)
    torch.cuda.synchronize()
    assert torch.isnan(want[1]).any()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def _k3_case(k, d, n_empty, seed, int_counts=True, k_reseed=None, big=False):
    rng = np.random.default_rng(seed)
    sums = rng.normal(size=(k, d)).astype(np.float32)
    lo, hi = ((1 << 24) + 1, 1 << 30) if big else (1, 50)
    counts = rng.integers(lo, hi, size=k)
    counts[rng.choice(k, size=n_empty, replace=False)] = 0
    counts = counts.astype(np.int32 if int_counts else np.float32)
    reseed = rng.normal(size=(k if k_reseed is None else k_reseed, d))
    return sums, counts, reseed.astype(np.float32)


K3_CASES = [  # (K, D, empty, int counts, K', counts above 2^24)
    (8, 128, 2, True, None, False), (8, 128, 2, False, None, False),
    (2, 128, 1, True, None, False), (1, 7, 1, True, None, False),
    (1, 128, 0, False, None, False), (65, 3, 20, False, None, False),
    (64, 128, 64, True, None, False), (2048, 128, 100, True, 100, False),
    (2048, 128, 30, True, None, True), (2048, 37, 0, False, None, False),
    (14000, 128, 900, False, None, False), (20614, 128, 322, True, None,
                                             False),
    (20614, 128, 0, True, None, True), (3000, 1024, 10, True, None, False),
]


@pytest.mark.parametrize("case", K3_CASES)
def test_kmeans_mstep_kernel_bit_equal_at_every_shape(cuda, case):
    """K3 bit-equal to its plain version in one launch: int32 and f32
    counts, none, some and all empty, K' above and at the number of empty
    clusters, counts above 2^24, K 1 to 20,614 and D 3 to 1,024."""
    from repro_torch.kernels import kmeans_mstep as tmstep
    from repro_torch.kernels.cuda_lib import LAUNCHES

    k, d, n_empty, int_counts, k_reseed, big = case
    s, c, r = _dev(_k3_case(k, d, n_empty, seed=k + d,
                            int_counts=int_counts, k_reseed=k_reseed,
                            big=big), cuda)
    want = tmstep.kmeans_mstep_plain(s, c, r)
    before = LAUNCHES.snapshot()["kmeans_mstep"]
    got = tmstep.kmeans_mstep_cuda(s, c, r)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot()["kmeans_mstep"] == before + 1
    assert torch.equal(got, want)


def test_kmeans_mstep_kernel_takes_4_byte_words_when_misaligned(cuda):
    from repro_torch.kernels import kmeans_mstep as tmstep

    s, c, r = _dev(_k3_case(2048, 128, 100, seed=3), cuda)
    buf = torch.empty(s.numel() + 1, dtype=torch.float32, device=cuda)
    mis = buf[1:].view(s.shape)
    mis.copy_(s)
    assert tmstep.kmeans_mstep_variant(128, mis.data_ptr(), r.data_ptr(),
                                       0) == "vec4"
    assert torch.equal(tmstep.kmeans_mstep_cuda(mis, c, r),
                       tmstep.kmeans_mstep_plain(mis, c, r))
    with pytest.raises(ValueError, match="int32 or f32"):
        tmstep.kmeans_mstep_cuda(s, c.to(torch.int64), r)


def test_stage2_stream_overlaps_on_card(cuda, tmp_path):
    """On the card the loader's slice and copy of shard i+1 land inside
    shard i's assign window somewhere, and the streamed and elastic
    branches hash the same.  Stage 1 is given (20,000 centroids, the 1M
    index's count, drawn from the corpus), so the 5,000-row shards' assign
    runs as long as the 1M build's: with a few hundred centroids it ends
    before the host has issued it, and nothing can overlap."""
    import os

    from repro_torch.build.pipeline import BuildConfig, build_index, \
        index_content_hash
    from repro_torch.build.stream import pair_overlaps
    from repro_torch.data.synthetic import PAPER_DATASETS, make_vectors

    spec = dataclasses.replace(PAPER_DATASETS["sift"], n=40000, dim=128)
    x = make_vectors(spec)
    cents = x[np.random.default_rng(0).choice(len(x), 20000, replace=False)]
    cfg = BuildConfig(max_cluster_size=96, cluster_len=128,
                      coarse_per_task=5000)
    for tag in ("s", "e"):
        os.makedirs(tmp_path / tag)
        np.save(tmp_path / tag / "stage1_centroids.npy", cents)
    idx, _, rep = build_index(x, cfg, str(tmp_path / "s"), device=cuda)
    assert rep.resumed_stages == ["stage1"] and len(rep.shard_stamps) == 8
    assert max(pair_overlaps(rep.shard_stamps)) > 0.0
    assert 0.0 < rep.shard_overlap <= 1.0
    idx_e, _, _ = build_index(
        x, dataclasses.replace(cfg, stream_stage2=False),
        str(tmp_path / "e"), device=cuda)
    assert index_content_hash(idx_e) == index_content_hash(idx)


def test_fresh_merge_on_card_matches_cpu(cuda):
    from repro_torch.core.fresh import merge_fresh

    rng = np.random.default_rng(4)
    b, kw, cap, d, n_main = 32, 24, 4096, 128, 10000
    q = rng.normal(size=(b, d)).astype(np.float32)
    main_i = np.stack([rng.permutation(n_main)[:kw]
                       for _ in range(b)]).astype(np.int32)
    main_d = np.sort(rng.uniform(50, 300, size=(b, kw)), axis=1).astype(
        np.float32)
    dv = (q[rng.integers(0, b, size=cap)]
          + rng.normal(size=(cap, d))).astype(np.float32)
    di = (n_main + np.arange(cap)).astype(np.int32)
    di[cap // 2:] = -1
    tomb = np.zeros((n_main + cap,), bool)
    tomb[rng.choice(n_main + cap // 2, size=500, replace=False)] = True
    args = [main_d, main_i, q, dv, di, tomb]
    gd, gi = merge_fresh(*_dev(args, cuda), kw)
    cd, ci = merge_fresh(*_dev(args, "cpu"), kw)
    torch.cuda.synchronize()
    assert_candidates_match(gd.cpu(), gi.cpu(), cd, ci, tol=1e-4)


# --------------------------------------------------------------------------
# the mesh on the card: sharded engines (NCCL, one rank) and the sharded
# Lloyd step (four gloo ranks sharing the card)
# --------------------------------------------------------------------------
def _mesh_index(tmp_path):
    """A 2,000 x 16 index (clusters padded to a multiple of 4) with its q8
    payload, written as the mesh jobs read it; returns the arrays."""
    from repro_torch.build.kmeans import balanced_hierarchical_kmeans
    from repro_torch.core.ivf import build_postings
    from repro_torch.core.quantize import quantize_postings
    from repro_torch.core.spann_rules import closure_assign

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 16)).astype(np.float32)
    q = rng.normal(size=(64, 16)).astype(np.float32)
    cents, _ = balanced_hierarchical_kmeans(x, 40, iters=6, device="cpu")
    ca = closure_assign(torch.from_numpy(x), torch.from_numpy(cents),
                        eps=0.2).numpy()
    post, pids = build_postings(x, ca, cents.shape[0], 48)
    pad = -cents.shape[0] % 4
    cents = np.concatenate([cents, np.full((pad, 16), 1e6, np.float32)])
    post = np.concatenate([post, np.zeros((pad, 48, 16), np.float32)])
    pids = np.concatenate([pids, np.full((pad, 48), -1, np.int32)])
    qp = quantize_postings(torch.from_numpy(post), torch.from_numpy(cents),
                           torch.from_numpy(pids))
    arrays = {"centroids": cents, "postings": post, "posting_ids": pids,
              "q8": qp.q8.numpy(), "qscale": qp.scale.numpy(),
              "qnorm2": qp.norm2.numpy(), "queries": q,
              "topk": np.full(len(q), 10, np.int32)}
    for name, a in arrays.items():
        np.save(tmp_path / f"{name}.npy", a)
    return arrays


def test_sharded_engines_on_card_match_serve_step(cuda, tmp_path):
    """The f32 (B2) and q8 (K1) sharded engines at one NCCL rank on the
    card give serve_step's ids up to ties and its nprobe, and launch their
    kernels once a batch."""
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.core.quantize import attach_quantized
    from repro_torch.core.search import SearchConfig, serve_step
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import mesh_jobs
    from repro_torch.launch.mesh import spawn

    arrays = _mesh_index(tmp_path)
    cuda_lib.library()                     # built once, before the ranks
    cfg = dict(k=10, nprobe_max=16, pruning="none")
    jobs = [{"kind": "serve", "shape": (1, 1), "work": str(tmp_path),
             "engine": e, "cfg": dict(cfg, shard_centroids=sc), "batch": 32}
            for e, sc in (("f32", False), ("f32", True), ("q8", False))]
    res = spawn(mesh_jobs.run, (1,), ("data",), backend="nccl",
                device="cuda", args=(jobs,), timeout_s=300)[0]
    index = attach_quantized(IVFIndex(
        *(torch.from_numpy(arrays[n]).to(cuda)
          for n in ("centroids", "postings", "posting_ids"))))
    q = torch.from_numpy(arrays["queries"]).to(cuda)
    tk = torch.from_numpy(arrays["topk"]).to(cuda)
    for r, tier, kernel in ((res[0], "f32", "ivf_scan_topk"),
                            (res[1], "f32", "ivf_scan_topk"),
                            (res[2], "q8", "ivf_scan_q8_topk")):
        want = [serve_step(index, None, q[s:s + 32], tk[s:s + 32],
                           SearchConfig(**cfg, tier=tier)) for s in (0, 32)]
        np.testing.assert_array_equal(
            r["nprobe"], torch.cat([w["nprobe"] for w in want]).cpu())
        assert_candidates_match(
            r["dists"], r["ids"],
            torch.cat([w["dists"] for w in want]).cpu(),
            torch.cat([w["ids"] for w in want]).cpu(),
            tol=1e-4 if tier == "f32" else 1e-3)
        assert r["launches"][kernel] == 2
        assert not r["host_staged"]


def test_kmeans_sharded_step_on_card_four_gloo_ranks(cuda, tmp_path):
    """kmeans_sharded_step at four gloo ranks sharing the card (K2 on each
    rank's rows, CUDA tensors staged through host memory for gloo) against
    one K2 over every row and the same M-step: counts exact, centroids
    within 1e-5."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import mesh_jobs
    from repro_torch.launch.mesh import spawn

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(64, 32))[rng.integers(0, 64, 40_000)]
         + 0.2 * rng.normal(size=(40_000, 32))).astype(np.float32)
    cents = x[rng.choice(len(x), 128, replace=False)].copy()
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "cents.npy", cents)
    cuda_lib.library()
    res = spawn(mesh_jobs.run, (4,), ("data",), backend="gloo",
                device="cuda", args=([{"kind": "kmeans", "shape": (4, 1),
                                       "work": str(tmp_path)}],),
                timeout_s=300)
    xd, cd = torch.from_numpy(x).to(cuda), torch.from_numpy(cents).to(cuda)
    _, _, sums, counts = kops.kmeans_assign_update(xd, cd)
    c = counts.to(torch.float32)[:, None]
    want = torch.where(c > 0, sums / torch.clamp_min(c, 1.0), cd).cpu()
    r0 = res[0][0]
    np.testing.assert_array_equal(r0["counts"], counts.cpu().numpy())
    np.testing.assert_allclose(r0["centroids"], want.numpy(), rtol=1e-5,
                               atol=1e-5)
    for (r,) in res:
        assert r["launches"]["kmeans_assign_update"] >= 1
        assert r["launches"]["kmeans_mstep"] == 0


# --------------------------------------------------------------------------
# the recsys family on the card
# --------------------------------------------------------------------------
RS_ARCHS = ["xdeepfm", "wide_deep", "mind", "din"]


def _recsys_case(name, rows=2048, batch=256, seed=0):
    from repro_torch.configs import get
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models.recsys import init_params

    cfg = dataclasses.replace(get(name).config, table_rows=rows)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    b = recsys_batch(batch, cfg.n_sparse, rows, seq_len=cfg.seq_len,
                     seed=seed)
    return cfg, params, {k: torch.from_numpy(v) for k, v in b.items()}


def _to(tree, device):
    from repro_torch.distributed.collectives import tree_map

    return tree_map(lambda t: t.to(device), tree)


@pytest.mark.parametrize("name", RS_ARCHS)
def test_recsys_step_card_matches_cpu(cuda, name):
    """One train step of each arch at a 2,048-row table on the card against
    the same step on the CPU from the same parameters and batch: the loss
    within rtol 1e-5, the parameters within STEP_PARAM_ATOL."""
    from _torch_port import STEP_PARAM_ATOL
    from repro_torch.distributed.collectives import tree_flatten
    from repro_torch.models.recsys import make_train_step
    from repro_torch.optim import adamw

    cfg, params, batch = _recsys_case(name)
    step = make_train_step(cfg)
    wp, wo, wm = step(params, adamw.init(params), batch)
    cp = _to(params, cuda)
    gp, go, gm = step(cp, adamw.init(cp), _to(batch, cuda))
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-5)
    for got, want in ((gp, wp), (go.mu, wo.mu)):
        for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            assert g.is_cuda
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                       atol=STEP_PARAM_ATOL, err_msg=name)


def test_mind_steps_bit_equal_on_the_card(cuda):
    """Two identical MIND steps from one state on the card give the same
    bits (the gather's backward sums repeated Zipf ids in a fixed order)."""
    from repro_torch.distributed.collectives import tree_flatten
    from repro_torch.models.recsys import make_train_step
    from repro_torch.optim import adamw

    cfg, params, batch = _recsys_case("mind", rows=1 << 16, batch=4096)
    params, batch = _to(params, cuda), _to(batch, cuda)
    step = make_train_step(cfg)
    opt = adamw.init(params)
    params, opt, _ = step(params, opt, batch)      # non-zero moments
    a = step(params, opt, batch)[:2]
    b = step(params, opt, batch)[:2]
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        # every leaf is float32 or int32: compare the bits
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_ckpt_roundtrip_of_cuda_tensors(cuda, tmp_path):
    """A tree of CUDA tensors, bfloat16 included, saved and restored onto
    the card bit for bit, each leaf on its tree_like leaf's device and
    dtype."""
    from repro_torch import ckpt
    from repro_torch.distributed.collectives import tree_flatten

    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn((64, 3), generator=g, device=cuda),
            "opt": [torch.arange(5, dtype=torch.int32, device=cuda),
                    {"m": torch.randn((4, 4), generator=g, device=cuda)
                     .to(torch.bfloat16)}]}
    ckpt.save(tree, 1, str(tmp_path), extra={"cursor": 1})
    like = {"w": torch.zeros((64, 3), device=cuda),
            "opt": [torch.zeros(5, dtype=torch.int32, device=cuda),
                    {"m": torch.zeros((4, 4), dtype=torch.bfloat16,
                                      device=cuda)}]}
    out, step, extra = ckpt.restore(like, str(tmp_path))
    assert step == 1 and extra == {"cursor": 1}
    for a, b in zip(tree_flatten(out)[0], tree_flatten(tree)[0]):
        assert a.device == b.device and a.dtype == b.dtype
        bits = (lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16
                else t)
        assert torch.equal(bits(a), bits(b))


# --------------------------------------------------------------------------
# the LM and GNN families
# --------------------------------------------------------------------------
def test_resolve_device_keeps_bf16_products_in_float32(cuda):
    """On the card every bf16 product accumulates in float32 to the end
    (no reduced-precision split-K reduction), as XLA's do."""
    from repro_torch.device import resolve_device

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32


def test_moe_layer_and_segment_sum_repeat_bit_for_bit(cuda):
    """The MoE combine (each token's K outputs added in order) and
    GraphCast's scatter-add give the same bits in two runs on the card,
    the gradients through the gathers included; the card's layer equals
    the CPU's within bf16 rounding."""
    from repro_torch.configs import get
    from repro_torch.models.gnn.graphcast import segment_sum
    from repro_torch.models.lm.moe import moe_ffn, moe_param_shapes

    moe = get("qwen2_moe").config.moe
    d = 256
    g = torch.Generator().manual_seed(0)
    lp = {k: (torch.randn(s.shape, generator=g) / s.shape[-2] ** 0.5).to(
        s.dtype) for k, s in moe_param_shapes(moe, d, (), torch.bfloat16)
        .items()}
    x = torch.randn((2, 512, d), generator=g).to(torch.bfloat16)
    lpc = {k: v.to(cuda) for k, v in lp.items()}

    def run():
        xc = x.to(cuda).requires_grad_(True)
        out = moe_ffn(xc, lpc, moe, None)
        (gx,) = torch.autograd.grad(out.float().square().sum(), xc)
        return out.detach(), gx

    (a, ga), (b, gb) = run(), run()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(ga.view(torch.int16), gb.view(torch.int16))
    want = moe_ffn(x, lp, moe, None).float()
    err = (a.float().cpu() - want).abs().max() / want.abs().max()
    assert float(err) < 2e-2
    m = torch.randn((100_000, 64), generator=g).to(cuda)
    ids = torch.randint(0, 5000, (100_000,), generator=g).to(cuda)
    s1, s2 = segment_sum(m, ids, 5000), segment_sum(m, ids, 5000)
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))
    np.testing.assert_allclose(
        s1.cpu().numpy(), segment_sum(m.cpu(), ids.cpu(), 5000).numpy(),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["phi4_mini", "qwen2_moe", "gemma3_27b"])
def test_lm_step_card_matches_cpu(cuda, name):
    """One step of the scaled config on the card against the CPU: the
    loss within rtol 1e-5, every parameter within 2.5 lr and all but the
    share tests/test_torch_lm.py allows within STEP_PARAM_ATOL."""
    from _torch_port import STEP_PARAM_ATOL

    from repro_torch.configs import get
    from repro_torch.distributed.collectives import tree_flatten, tree_map
    from repro_torch.launch.train import scaled_lm_config
    from repro_torch.models.lm import init_params, make_train_step
    from repro_torch.optim import adamw

    share = {"phi4_mini": 0.0, "qwen2_moe": 0.0, "gemma3_27b": 4e-2}[name]
    cfg = scaled_lm_config(get(name).config, 0.02)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 33)))
    step = make_train_step(cfg)
    wp, _, wm = step(params, adamw.init(params), toks)
    cp = tree_map(lambda t: t.to(cuda), params)
    gp, _, gm = step(cp, adamw.init(cp), toks.to(cuda))
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-5)
    off = n = 0
    for a, b in zip(tree_flatten(gp)[0], tree_flatten(wp)[0]):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2.5 * adamw.AdamWConfig().lr
        off += int((d > STEP_PARAM_ATOL).sum())
        n += d.numel()
    assert off <= share * n
