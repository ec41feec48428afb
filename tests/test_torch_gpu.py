"""Card-only tests of the port (marker ``gpu``; they skip where there is no
CUDA card).  Each CUDA kernel is held against its plain torch version, a
small build + serve on the card against the same pipeline on the CPU, and
the resident serve path and the unfused build on the card.
This file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (  # noqa: E402,F401
    assert_candidates_match, cuda, f32_case, grid_points, q8_case,
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
    assert counts["kmeans_assign_update"] > 0 and counts["kmeans_mstep"] > 0
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
