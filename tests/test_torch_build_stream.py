"""The port's streamed stage 2 (``repro_torch.build.stream``) against the
JAX package's on the CPU: the reference's three stage-2 tests
(``tests/test_pipeline.py``) run on the port's ``build_index``, the two
``ShardAssignPipeline``s on the same corpus, centroids and spans (byte-equal
assign files), the overlap metrics on the same stamps (equal floats), and
the delta-mode manifest and plan (equal, stale checkpoints removed).

On the CPU the port's dispatch is synchronous, so these tests hold the
stamps' order and the overlap's range; a positive overlap is asserted on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import torch_threads  # noqa: E402,F401
from repro_torch.build.pipeline import BuildConfig, build_index, \
    index_content_hash  # noqa: E402
from repro_torch.build import stream as tstream  # noqa: E402

CFG = dict(max_cluster_size=48, cluster_len=64, coarse_per_task=800,
           n_workers=2)


def _spans(n, per):
    return [(s, min(s + per, n)) for s in range(0, n, per)]


@pytest.fixture(scope="module")
def built(tmp_path_factory, small_corpus):
    x, _, _ = small_corpus
    wd = str(tmp_path_factory.mktemp("port_stream_build"))
    cfg = BuildConfig(**CFG)
    idx, _, report = build_index(x, cfg, wd, device="cpu")
    return wd, cfg, idx, report


def test_stage2_stream_stamps_are_ordered(built):
    """Every shard is stamped in stage order, and the overlap measure is
    a fraction; the default build runs the streamed branch."""
    wd, cfg, _, report = built
    assert cfg.stream_stage2
    stamps = report.shard_stamps
    assert len(stamps) == len(os.listdir(os.path.join(wd, "shards"))) >= 2
    live = [t for t in stamps if not t["resumed"]]
    assert len(live) == len(stamps)
    for t in live:
        assert t["load_start"] <= t["load_end"] <= t["stream_end"]
        assert t["stream_end"] <= t["assign_dispatch"] <= t["assign_done"]
        assert t["assign_done"] <= t["harvest_end"]
        assert t["bytes"] == t["rows"] * 24 * 4
    assert len(tstream.pair_overlaps(stamps)) == len(live) - 1
    assert 0.0 <= report.shard_overlap <= 1.0
    assert report.postings_s > 0.0
    assert "stage2" not in report.resumed_stages


def test_resume_mid_stage2_identical_hash(built, small_corpus):
    """Delete one finished shard checkpoint and rebuild: only that shard
    re-runs, and the index hashes the same."""
    wd, cfg, idx, _ = built
    x, _, _ = small_corpus
    h0 = index_content_hash(idx)
    shards = sorted(os.listdir(os.path.join(wd, "shards")))
    os.remove(os.path.join(wd, "shards", shards[1]))
    idx2, _, report2 = build_index(x, cfg, wd, device="cpu")
    assert "stage2:partial" in report2.resumed_stages
    n_resumed = sum(1 for t in report2.shard_stamps if t["resumed"])
    assert n_resumed == len(shards) - 1
    assert index_content_hash(idx2) == h0


def test_streamed_stage2_matches_elastic_path(small_corpus, tmp_path):
    """A schedule change, not an artifact change: from the same stage-1
    centroids both branches write byte-equal assign files and hash the
    same."""
    x, _, _ = small_corpus
    wd_s, wd_e = str(tmp_path / "s"), str(tmp_path / "e")
    idx_s, _, rep_s = build_index(x, BuildConfig(**CFG), wd_s, device="cpu")
    os.makedirs(wd_e)
    shutil.copy(os.path.join(wd_s, "stage1_centroids.npy"),
                os.path.join(wd_e, "stage1_centroids.npy"))
    idx_e, _, rep_e = build_index(x, BuildConfig(**CFG, stream_stage2=False),
                                  wd_e, device="cpu")
    assert "stage1" in rep_e.resumed_stages
    assert rep_e.shard_stamps == [] and rep_s.shard_stamps
    assert index_content_hash(idx_s) == index_content_hash(idx_e)
    names = sorted(os.listdir(os.path.join(wd_s, "shards")))
    assert names == sorted(os.listdir(os.path.join(wd_e, "shards")))
    for name in names:
        a = np.load(os.path.join(wd_s, "shards", name))["assign"]
        b = np.load(os.path.join(wd_e, "shards", name))["assign"]
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def stage1(small_corpus):
    from repro.build.kmeans import balanced_hierarchical_kmeans

    x, _, _ = small_corpus
    cents, _ = balanced_hierarchical_kmeans(x, max_cluster_size=48, iters=8)
    return x, np.asarray(cents, np.float32)


@pytest.mark.parametrize("per,eps,replicas", [(800, 0.2, 4), (1500, 0.5, 2),
                                              (4000, 0.2, 4)])
def test_shard_pipelines_write_byte_equal_assign_files(stage1, tmp_path,
                                                       per, eps, replicas):
    """The port's and the reference's ShardAssignPipeline on the same
    corpus, centroids and spans: byte-equal checkpoint files, the same
    bytes streamed, and the same shard stamps' shape."""
    from repro.build.stream import ShardAssignPipeline as JPipe

    x, cents = stage1
    spans = _spans(len(x), per)
    pj = [str(tmp_path / f"j{i}.npz") for i in range(len(spans))]
    pt = [str(tmp_path / f"t{i}.npz") for i in range(len(spans))]
    jp = JPipe(x, cents, spans, pj, eps=eps, max_replicas=replicas)
    tp = tstream.ShardAssignPipeline(x, cents, spans, pt, eps=eps,
                                     max_replicas=replicas, device="cpu")
    try:
        js, ts = jp.run(), tp.run()
    finally:
        jp.close()
        tp.close()
    for a, b in zip(pj, pt):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert tp.bytes_streamed == jp.bytes_streamed == x.nbytes
    assert [t.rows for t in ts] == [t.rows for t in js]
    # a second run resumes every shard and streams nothing
    tp2 = tstream.ShardAssignPipeline(x, cents, spans, pt, eps=eps,
                                      max_replicas=replicas, device="cpu")
    try:
        again = tp2.run_sequential()
    finally:
        tp2.close()
    assert all(t.resumed for t in again) and tp2.bytes_streamed == 0


def _stamp_dicts(seed):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for i in range(6):
        ls = t + rng.uniform(0, 1)
        le = ls + rng.uniform(0, 1)
        se = le + rng.uniform(0, 1)
        ad = se + rng.uniform(-0.5, 1)
        dn = ad + rng.uniform(0, 2)
        out.append(dict(shard=i, rows=10, bytes=40, resumed=bool(i == 2),
                        load_start=ls, load_end=le, stream_end=se,
                        assign_dispatch=ad, assign_done=dn))
        t = ad
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_metrics_equal_the_reference(seed):
    from repro.build import stream as jstream

    stamps = _stamp_dicts(seed)
    assert tstream.pair_overlaps(stamps) == jstream.pair_overlaps(stamps)
    assert tstream.shard_overlap_efficiency(stamps) \
        == jstream.shard_overlap_efficiency(stamps)
    objs = [tstream.ShardStageTimes(**s) for s in stamps]
    assert tstream.pair_overlaps(objs) == jstream.pair_overlaps(stamps)


def test_delta_manifest_and_plan_equal_the_reference(stage1, tmp_path):
    """make_shard_manifest and plan_delta_shards of both packages: equal
    manifests and plans on a cold build, on an append (trusted and
    re-hashed) and after the centroids change; stale checkpoints are
    removed alike."""
    from repro.build import stream as jstream

    x, cents = stage1
    spans = _spans(len(x), 1000)
    assert tstream.make_shard_manifest(x, spans, cents) \
        == jstream.make_shard_manifest(x, spans, cents)
    assert tstream.array_content_hash(x) == jstream.array_content_hash(x)
    x2 = np.concatenate([x, x[:700] + 1.0]).astype(np.float32)
    spans2 = _spans(len(x2), 1000)
    prev = tstream.make_shard_manifest(x, spans, cents)
    for label, xx, sp, cc, trust in (
            ("cold", x, spans, cents, True),
            ("append", x2, spans2, cents, True),
            ("append rehash", x2, spans2, cents, False),
            ("new centroids", x2, spans2, cents + 1.0, True)):
        plans = []
        for pkg, tag in ((tstream, "t"), (jstream, "j")):
            paths = [str(tmp_path / f"{tag}_{label}_{i}.npz")
                     for i in range(len(sp))]
            for p in paths[:4]:             # checkpoints of the old spans
                np.savez(p, assign=np.zeros(1, np.int32))
            plan = pkg.plan_delta_shards(
                xx, sp, paths, cc, None if label == "cold" else prev,
                trust_manifest=trust)
            plans.append((plan, [os.path.exists(p) for p in paths]))
        (tp, t_exist), (jp, j_exist) = plans
        assert (tp.dirty, tp.reused, tp.bytes_dirty, tp.bytes_reused,
                tp.manifest) == (jp.dirty, jp.reused, jp.bytes_dirty,
                                 jp.bytes_reused, jp.manifest), label
        assert t_exist == j_exist, label
        assert all(not t_exist[i] for i in tp.dirty)
