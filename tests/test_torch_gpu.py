"""Card-only tests of the port (marker ``gpu``; they skip where there is no
CUDA card).  Each CUDA kernel is held against its plain torch version, a
small build + serve on the card against the same pipeline on the CPU, and
the resident serve path and the unfused build on the card.
This file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The batched k-means K23 is held against its plain version and, bit for
bit, against the per-node CUDA loop (K2, sort, K3) it replaces.
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


F32_CASES = [  # (C, L, D, B, P, dead, masked, dup, nan_dead, k2)
    (16, 8, 16, 8, 4, 0.0, 0.2, False, False, 10),
    (32, 16, 32, 6, 8, 0.3, 0.3, True, True, 10),     # ragged B, NaN dead
    (9, 16, 24, 5, 3, 0.5, 0.5, False, True, 40),     # k2 > live candidates
    (20, 64, 1024, 3, 4, 0.1, 0.0, True, False, 256),  # D 1024, k2 256
    (300, 128, 128, 32, 16, 0.05, 0.1, False, True, 24),  # the main shape
]


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_topk_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import ivf_scan as tscan

    c, l, d, b, p, dead, masked, dup, nan_dead, k2 = case
    arrays = _dev(f32_case(c, l, d, b, p, seed=c, dead=dead, masked=masked,
                           dup=dup, nan_dead=nan_dead), cuda)
    gd, gi = tscan.ivf_scan_topk_cuda(*arrays, k2=k2)
    wd, wi = tscan.ivf_scan_topk_plain(*arrays, k2=k2)
    torch.cuda.synchronize()
    assert not torch.isnan(gd).any()
    assert_candidates_match(gd.cpu(), gi.cpu(), wd.cpu(), wi.cpu(), tol=1e-4)


def _b2_special_case(kind):
    """B2 inputs for one merge edge: "dup_id" gives one id to a row of a
    low and of a high cluster that query 0 probes, so the two copies land
    in different chunks; "masked" masks every probe of query 3; "k2_big"
    asks for more candidates than the live rows hold."""
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


@pytest.mark.parametrize("chunks", [1, 2, 7, None, 64])
@pytest.mark.parametrize("kind", ["dup_id", "masked", "k2_big"])
def test_f32_topk_kernel_chunks_match_plain(cuda, kind, chunks):
    """B2 splits a tile's plan over ``chunks`` blocks (None: the card's
    own count) and merges their partial top-k2: the same candidates as the
    plain version at one chunk and at many."""
    from repro_torch.kernels import ivf_scan as tscan

    arrays, k2 = _b2_special_case(kind)
    arrays = _dev(arrays, cuda)
    s_len = 8 * arrays[2].shape[1]
    n = None if chunks is None else min(chunks, s_len)
    gd, gi = tscan.ivf_scan_topk_cuda(*arrays, k2=k2, chunks=n)
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
    the plain versions follow): B2 at one chunk and at many, and K1."""
    from repro_torch.kernels import ivf_scan as tscan
    from repro_torch.kernels import ivf_scan_q8 as tq8

    if kernel == "ivf_scan_topk":
        arrays = f32_case(40, 32, 64, 16, 8, seed=42, dead=0.1, masked=0.1)
        post, ids, cids, mask, _ = arrays
        plant_nan(post, ids, cids, mask, where, q=1)
        arrays = _dev(arrays, cuda)
        want = tscan.ivf_scan_topk_plain(*arrays, k2=24)
        gots = [tscan.ivf_scan_topk_cuda(*arrays, k2=24, chunks=n)
                for n in (1, 5, None)]
        tol = 1e-4
    else:
        arrays = q8_case(40, 32, 64, 16, 8, seed=43, dead=0.1, masked=0.1)
        plant_nan(arrays[2], arrays[4], arrays[5], arrays[6], where, q=1)
        arrays = _dev(arrays, cuda)
        want = tq8.ivf_scan_q8_topk_plain(*arrays, k2=24)
        gots = [tq8.ivf_scan_q8_topk_cuda(*arrays, k2=24)]
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


def _cmajor_case(c, l, d, b, a_n, seed, nan_row=False):
    """Postings, an active-cluster list with duplicates and out-of-range
    ids, a selection mask and queries; ``nan_row`` puts a NaN in one row of
    an active cluster."""
    rng = np.random.default_rng(seed)
    post, _, _, _, q = f32_case(c, l, d, b, 1, seed=seed)
    active = rng.integers(-2, c + 2, size=a_n).astype(np.int32)
    active[-1] = active[0]
    qsel = rng.random((a_n, b)) < 0.6
    if nan_row:
        post[np.clip(active[0], 0, c - 1), l // 2, d // 3] = np.nan
        qsel[0] = True
    return post, active, qsel, q


CMAJOR_CASES = [  # (C, L, D, B, A, nan_row)
    (16, 8, 16, 4, 6, False),
    (32, 16, 32, 13, 12, True),          # ragged B, NaN in a live row
    (20, 40, 1024, 5, 7, False),         # D 1024: several D slices
    (600, 128, 128, 32, 458, False),     # the union of one streamed batch
]


@pytest.mark.parametrize("case", CMAJOR_CASES)
def test_clustermajor_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import ivf_scan as tscan

    c, l, d, b, a_n, nan_row = case
    arrays = _dev(_cmajor_case(c, l, d, b, a_n, seed=a_n, nan_row=nan_row),
                  cuda)
    got = tscan.ivf_scan_clustermajor_cuda(*arrays)
    want = tscan.ivf_scan_clustermajor_plain(*arrays)
    torch.cuda.synchronize()
    qsel = arrays[2]
    assert (got.permute(0, 2, 1)[~qsel] == float("inf")).all()
    assert torch.isnan(got).any() == nan_row
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               equal_nan=True)


Q8_LEGACY_CASES = [  # (C, L, D, B, P, masked, nan_norm)
    (16, 8, 16, 4, 4, 0.2, False),
    (40, 48, 24, 13, 7, 0.3, True),      # ragged B, NaN in a live norm
    (20, 64, 1024, 3, 4, 0.0, False),    # D 1024
    (300, 128, 128, 32, 16, 0.1, False),  # one resident batch
]


@pytest.mark.parametrize("case", Q8_LEGACY_CASES)
def test_q8_legacy_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import ivf_scan_q8 as tq8

    c, l, d, b, p, masked, nan_norm = case
    q8, scale, norm2, cents, ids, cids, mask, q = q8_case(
        c, l, d, b, p, seed=c + 1, dead=0.2, masked=masked, dup=True)
    cids[0, -1] = c + 5                   # out of range: clamped to C - 1
    cids[-1, 0] = -3                      # out of range: clamped to 0
    if nan_norm:
        mask[1, 2] = True
        norm2[cids[1, 2], l // 2] = np.nan
    arrays = _dev((q8, scale, norm2, cents, cids, mask, q), cuda)
    got = tq8.ivf_scan_q8_cuda(*arrays)
    want = tq8.ivf_scan_q8_plain(*arrays)
    torch.cuda.synchronize()
    m = arrays[5]
    assert (got[~m] == float("inf")).all()
    assert torch.isnan(got).any() == nan_norm
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3,
                               equal_nan=True)


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
