"""Card-only tests of the port (marker ``gpu``; they skip where there is no
CUDA card).  Each CUDA kernel is held against its plain torch version, and
a small build + serve on the card against the same pipeline on the CPU.
This file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (  # noqa: E402,F401
    assert_candidates_match, cuda, grid_points, q8_case, torch_threads,
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
