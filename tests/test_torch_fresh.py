"""The port's freshness layer (``repro_torch.core.fresh``) and update lane
(``repro_torch.lifecycle.ingest``) on the CPU: the counterparts of
``tests/test_fresh.py`` and of ``tests/test_lifecycle.py``'s state, lane,
epoch and engine-routing tests; ``merge_fresh`` of both packages on
identical inputs (ids equal up to ties, distances within 1e-4); the q8
pipeline with a ``fresh_source`` against the JAX pipeline with the same
snapshot over the converted index (q8 tolerance 1e-3); and a published
snapshot that no later insert changes (the aliasing trap of
``torch.from_numpy``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_candidates_match, torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.core.distance import recall_at_k  # noqa: E402
from repro_torch.core.fresh import FreshIndex, merge_fresh, rebuild  # noqa: E402
from repro_torch.core.ivf import brute_force_topk  # noqa: E402
from repro_torch.core.search import SearchConfig  # noqa: E402
from repro_torch.lifecycle import (  # noqa: E402
    LiveFreshState, UpdateLane, VersionManager,
)
from repro_torch.runtime import (  # noqa: E402
    BatchPolicy, DynamicBatcher, PrefetchPipeline, ServeEngine,
)
from repro_torch.storage import TieredPostings  # noqa: E402


@pytest.fixture(scope="module")
def port_index(small_index):
    return convert.ivf_index(np.asarray(small_index.centroids),
                             np.asarray(small_index.postings),
                             np.asarray(small_index.posting_ids),
                             device="cpu")


@pytest.fixture()
def fresh(small_corpus, port_index):
    x, _, _ = small_corpus
    return FreshIndex(main=port_index, capacity=256, n_total=x.shape[0]), x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


# -------------------------------------------------------------------------
# core/fresh.py (tests/test_fresh.py's counterparts)
# -------------------------------------------------------------------------
def test_inserted_vectors_are_findable(fresh, rng):
    fi, x = fresh
    new = rng.normal(loc=5.0, size=(8, x.shape[1])).astype(np.float32)
    ids = fi.insert(new)
    d, i = fi.search(_t(new), k=3, nprobe=8)
    for row, want in zip(i.numpy(), ids):
        assert want in row.tolist()
    assert float(d[:, 0].max()) < 1e-3


def test_deletes_are_filtered(fresh):
    fi, x = fresh
    q = _t(x[:4])
    _, i0 = fi.search(q, k=1, nprobe=8)
    victims = i0.numpy()[:, 0]
    fi.delete(victims)
    _, i1 = fi.search(q, k=3, nprobe=8)
    for row, dead in zip(i1.numpy(), victims):
        assert dead not in row.tolist()


def test_delete_of_delta_insert(fresh, rng):
    fi, x = fresh
    new = rng.normal(loc=7.0, size=(2, x.shape[1])).astype(np.float32)
    ids = fi.insert(new)
    fi.delete(ids[:1])
    _, i = fi.search(_t(new), k=2, nprobe=8)
    assert ids[0] not in i.numpy().ravel().tolist()
    assert ids[1] in i.numpy()[1].tolist()


def test_buffer_full_signals_rebuild(fresh, rng):
    fi, x = fresh
    with pytest.raises(BufferError):
        fi.insert(rng.normal(size=(fi.capacity + 1, x.shape[1])).astype(
            np.float32))


def test_rebuild_folds_delta_and_drops_tombstones(fresh, rng, tmp_path):
    from repro_torch.build.pipeline import BuildConfig

    fi, x = fresh
    new = rng.normal(loc=5.0, size=(16, x.shape[1])).astype(np.float32)
    ids = fi.insert(new)
    fi.delete(np.arange(10))
    fi.delete(ids[:4])
    cfg = BuildConfig(max_cluster_size=48, cluster_len=64,
                      coarse_per_task=1500, n_workers=2)
    new_fi, old_ids, vecs = rebuild(fi, x, cfg, str(tmp_path))
    assert vecs.shape[0] == x.shape[0] - 10 + 16 - 4
    assert not set(range(10)) & set(old_ids.tolist())
    assert not set(ids[:4].tolist()) & set(old_ids.tolist())
    assert new_fi.main.device.type == "cpu"
    q = _t(vecs[:32])
    _, ti = brute_force_topk(_t(vecs), q, 5)
    _, i = new_fi.search(q, k=5, nprobe=16)
    assert recall_at_k(i.numpy(), ti.numpy()) > 0.8


def test_insert_exactly_at_capacity(fresh, rng):
    fi, x = fresh
    vecs = rng.normal(size=(fi.capacity, x.shape[1])).astype(np.float32)
    ids = fi.insert(vecs)
    assert fi.fill == fi.capacity and len(ids) == fi.capacity
    with pytest.raises(BufferError):
        fi.insert(vecs[:1])
    assert fi.fill == fi.capacity
    _, i = fi.search(_t(vecs[-2:]), k=1, nprobe=8)
    assert i.numpy()[:, 0].tolist() == ids[-2:].tolist()


def test_delete_then_reinsert_same_vector(fresh, rng):
    fi, x = fresh
    vec = rng.normal(loc=6.0, size=(1, x.shape[1])).astype(np.float32)
    (id0,) = fi.insert(vec)
    fi.delete(np.asarray([id0]))
    (id1,) = fi.insert(vec)
    assert id1 != id0
    d, i = fi.search(_t(vec), k=3, nprobe=8)
    row = i.numpy()[0].tolist()
    assert id1 in row and id0 not in row
    assert float(d[0, 0]) < 1e-3


def test_tombstoned_delta_ids_filtered_through_serve_leveled(
        small_corpus, small_index, port_index, rng):
    from repro.core.distance import squared_l2_chunked, topk_smallest
    from repro.core.ivf import search_flat
    from repro.core.llsp import LLSPConfig, train_llsp

    x, q, topk = small_corpus
    fi = FreshIndex(main=port_index, capacity=64, n_total=x.shape[0])
    lcfg = LLSPConfig(levels=(4, 8, 16, 32), recall_target=0.9,
                      n_ratio_features=8, n_trees=30, max_depth=4)
    qj = jnp.asarray(q)
    cdists, cid_order = topk_smallest(
        squared_l2_chunked(qj, small_index.centroids), 32)
    kmax = int(topk.max())
    _, true_ids = search_flat(small_index, qj, kmax, nprobe=32)
    true_ids = np.asarray(true_ids)
    col = np.arange(kmax)[None, :]
    true_ids = np.where(col < topk[:, None], true_ids, -1)
    params = train_llsp(lcfg, q, topk, np.asarray(cid_order),
                        np.asarray(cdists), true_ids,
                        np.asarray(small_index.posting_ids), x.shape[0])
    tparams = convert.llsp_from_reference(params, device="cpu")

    probe = rng.normal(loc=8.0, size=(2, x.shape[1])).astype(np.float32)
    ids = fi.insert(probe)
    fi.delete(ids[:1])
    cfg = SearchConfig(k=5, nprobe_max=32, pruning="llsp", n_ratio=8,
                       use_kernel=False, fused_topk=True)
    d, i = fi.search_leveled(tparams, probe, 5, cfg, pad=8)
    for row in i:
        assert ids[0] not in row.tolist()
    assert i[1][0] == ids[1]
    assert d[1][0] < 1e-3
    _, i_ref = fi.search(_t(probe), k=5, nprobe=32)
    assert i[1].tolist()[:3] == i_ref.numpy()[1].tolist()[:3]


# -------------------------------------------------------------------------
# merge_fresh of both packages
# -------------------------------------------------------------------------
@pytest.mark.parametrize("b,kw,cap,fill,k,n_dead,seed", [
    (6, 10, 64, 40, 10, 0, 0),
    (9, 24, 32, 32, 24, 12, 1),        # full buffer, tombstones both sides
    (5, 10, 8, 3, 10, 4, 2),           # capacity below k
    (16, 40, 128, 0, 10, 6, 3),        # empty delta
])
def test_merge_fresh_matches_jax(b, kw, cap, fill, k, n_dead, seed):
    from repro.core.fresh import merge_fresh as j_merge

    rng = np.random.default_rng(seed)
    d, n_main = 12, 500
    q = rng.normal(size=(b, d)).astype(np.float32)
    main_i = np.stack([rng.permutation(n_main)[:kw] for _ in range(b)])
    main_i = main_i.astype(np.int32)
    main_i[rng.random(main_i.shape) < 0.1] = -1
    main_d = np.sort(rng.uniform(0, 30, size=(b, kw)), axis=1).astype(
        np.float32)
    main_d[main_i < 0] = np.inf
    dv = np.zeros((cap, d), np.float32)
    di = np.full((cap,), -1, np.int32)
    dv[:fill] = q[rng.integers(0, b, size=fill)] + rng.normal(
        scale=0.5, size=(fill, d))
    di[:fill] = n_main + np.arange(fill)
    tomb = np.zeros((n_main + cap,), bool)
    tomb[rng.choice(n_main + max(fill, 1), size=n_dead, replace=False)] \
        = True
    jd, ji = j_merge(*(jnp.asarray(a) for a in (main_d, main_i, q, dv, di,
                                                tomb)), k)
    td, ti = merge_fresh(*(torch.from_numpy(a) for a in (main_d, main_i, q,
                                                          dv, di, tomb)), k)
    assert td.shape == (b, k) and ti.dtype == torch.int32
    assert_candidates_match(td.numpy(), ti.numpy(), np.asarray(jd),
                            np.asarray(ji), tol=1e-4)
    live = ti.numpy()[ti.numpy() >= 0]
    assert not tomb[live].any()


# -------------------------------------------------------------------------
# the q8 pipeline with a fresh_source against the JAX pipeline
# -------------------------------------------------------------------------
SERVE = dict(k=10, nprobe_max=16, pruning="none")


def _batches(q, size=16):
    return [(q[i:i + size], np.full(len(q[i:i + size]), 10, np.int32))
            for i in range(0, len(q), size)]


@pytest.mark.parametrize("with_flash", [True, False])
def test_fresh_q8_pipeline_matches_jax_pipeline(small_corpus, small_index,
                                                tmp_path, with_flash):
    from repro.core.search import SearchConfig as JCfg
    from repro.lifecycle import LiveFreshState as JState
    from repro.runtime import make_quantized_pipeline as j_make
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    x, _, _ = small_corpus
    rng = np.random.default_rng(5)
    n, d = x.shape
    ins = (x[rng.integers(0, n, size=48)]
           + 0.05 * rng.normal(size=(48, d))).astype(np.float32)
    queries = np.concatenate([
        ins[:24],                                       # self-queries
        (x[rng.integers(0, n, size=40)]
         + 0.2 * rng.normal(size=(40, d))).astype(np.float32)])
    _, top1 = brute_force_topk(_t(x), _t(queries[24:]), 1)
    dead = np.unique(top1.numpy()[:, 0])
    states = []
    for cls, kw in ((JState, {}), (LiveFreshState, {"device": "cpu"})):
        st = cls(dim=d, capacity=128, n_main=n, **kw)
        minted = st.insert(ins)
        st.delete(dead)
        st.delete(minted[40:44])                       # delta tombstones
        st.publish()
        states.append((st, minted))
    (jst, jmint), (tst, tmint) = states
    np.testing.assert_array_equal(jmint, tmint)
    # the reference's flash tier is read at every candidate id, so it holds
    # the inserted vectors at their minted ids (the port's re-rank reads
    # main ids only and keeps a delta id's exact distance from the merge)
    jpipe = j_make(small_index, None, JCfg(**SERVE, use_kernel=False),
                   vectors=np.concatenate([x, ins]), with_flash=with_flash,
                   flash_path=str(tmp_path / "j.f32"),
                   fresh_source=jst.snapshot)
    want = jpipe.run_pipelined(_batches(queries), depth=2)
    tindex = convert.ivf_index(np.asarray(small_index.centroids),
                               np.asarray(small_index.postings),
                               np.asarray(small_index.posting_ids),
                               device="cpu")
    tpipe = make_quantized_pipeline(
        tindex, None, SearchConfig(**SERVE), vectors=x,
        with_flash=with_flash, flash_path=str(tmp_path / "t.f32"),
        fresh_source=tst.snapshot, device="cpu")
    try:
        assert tpipe._scan_cfg.k > SERVE["k"]           # over-fetch
        assert tpipe.warmup() == 2
        got = tpipe.run_pipelined(_batches(queries), depth=2)
    finally:
        tpipe.close()
    g_ids = np.concatenate([o.ids for o in got])
    g_d = np.concatenate([o.dists for o in got])
    w_ids = np.concatenate([o.ids for o in want])
    w_d = np.concatenate([o.dists for o in want])
    assert_candidates_match(g_d, g_ids, w_d, w_ids, tol=1e-3)
    assert all(o.fresh_seq == tst.seq for o in got)
    assert (g_ids[:24, 0] == tmint[:24]).all()         # minted id at rank 0
    dead_all = set(dead.tolist()) | set(tmint[40:44].tolist())
    assert not dead_all & set(g_ids.ravel().tolist())


def test_flash_rerank_keeps_delta_ids_exact(small_corpus, small_index,
                                           tmp_path):
    """The port's re-rank reads only ids inside the flash tier (the
    corpus): a self-query of an inserted vector finds its minted id at rank
    0 at distance ~0.  The reference's re-rank reads every candidate id, so
    the same deployment raises there (ROADMAP §3, the reference's
    ``_rerank`` with a ``fresh_source``)."""
    from repro.core.search import SearchConfig as JCfg
    from repro.lifecycle import LiveFreshState as JState
    from repro.runtime import make_quantized_pipeline as j_make
    from repro_torch.runtime.pipeline import make_quantized_pipeline

    x, _, _ = small_corpus
    rng = np.random.default_rng(9)
    n, d = x.shape
    ins = (x[rng.integers(0, n, size=16)]
           + 0.05 * rng.normal(size=(16, d))).astype(np.float32)
    tst = LiveFreshState(dim=d, capacity=32, n_main=n, device="cpu")
    minted = tst.insert(ins)
    tst.publish()
    tindex = convert.ivf_index(np.asarray(small_index.centroids),
                               np.asarray(small_index.postings),
                               np.asarray(small_index.posting_ids),
                               device="cpu")
    tpipe = make_quantized_pipeline(
        tindex, None, SearchConfig(**SERVE), vectors=x,
        flash_path=str(tmp_path / "t.f32"), fresh_source=tst.snapshot,
        device="cpu")
    try:
        (res,) = tpipe.run_sequential(_batches(ins))
    finally:
        tpipe.close()
    assert (res.ids[:, 0] == minted).all()
    assert float(res.dists[:, 0].max()) < 1e-3
    jst = JState(dim=d, capacity=32, n_main=n)
    jst.insert(ins)
    jst.publish()
    jpipe = j_make(small_index, None, JCfg(**SERVE, use_kernel=False),
                   vectors=x, flash_path=str(tmp_path / "j.f32"),
                   fresh_source=jst.snapshot)
    with pytest.raises(IndexError):
        jpipe.run_sequential(_batches(ins))


def test_published_snapshot_never_changes_under_later_inserts():
    st = LiveFreshState(dim=4, capacity=8, n_main=10, device="cpu")
    st.insert(np.ones((2, 4)))
    st.delete(np.asarray([3]))
    st.publish()
    s1 = st.snapshot()
    before = [t.clone() for t in (s1.delta_vecs, s1.delta_ids,
                                  s1.tombstone)]
    assert s1.delta_vecs.data_ptr() != st._delta_vecs.ctypes.data
    st.insert(np.full((3, 4), 7.0))
    st.delete(np.asarray([0, 11]))
    for t, b in zip((s1.delta_vecs, s1.delta_ids, s1.tombstone), before):
        assert torch.equal(t, b)
    st.publish()
    s2 = st.snapshot()
    assert s2.seq == s1.seq + 1 and s2.fill == 5
    assert s2.tombstone[[0, 3, 11]].all() and not s1.tombstone[0]
    assert s1.fill == 2 and int(s1.delta_ids[2]) == -1


# -------------------------------------------------------------------------
# tests/test_lifecycle.py's state, lane, epoch and engine-routing tests
# -------------------------------------------------------------------------
CFG = SearchConfig(k=5, nprobe_max=8, pruning="none", use_kernel=False,
                   fused_topk=True)


def _mk_state(small_corpus, capacity=64):
    x, _, _ = small_corpus
    return LiveFreshState(dim=x.shape[1], capacity=capacity,
                          n_main=x.shape[0], device="cpu"), x


def _mk_pipe(port_index, state, **kw):
    tier = TieredPostings(port_index.postings.numpy(),
                          port_index.posting_ids.numpy(), device="cpu")
    return PrefetchPipeline(port_index, None, CFG, tier=tier, pad_batch=8,
                            row_bucket=32, fresh_source=state.snapshot,
                            device="cpu", **kw)


def _mk_engine(pipe, state, clock=None):
    lane = UpdateLane(state, clock=clock or (lambda: 0.0))
    policy = BatchPolicy(max_batch=16, max_wait_s=0.001, pad=8,
                         update_quantum=4)
    batcher = DynamicBatcher(policy, ["idx"])
    eng = ServeEngine({"idx": pipe}, batcher, clock=clock or (lambda: 0.0),
                      update_lanes={"idx": lane})
    return eng, lane


def test_state_mints_sequential_global_ids(small_corpus):
    st, x = _mk_state(small_corpus)
    n = x.shape[0]
    ids = st.insert(np.zeros((3, x.shape[1])))
    assert ids.tolist() == [n, n + 1, n + 2]
    with pytest.raises(BufferError):
        st.insert(np.zeros((st.capacity, x.shape[1])))
    assert st.fill == 3 and st.next_id == n + 3


def test_state_publish_is_monotonic_and_immutable(small_corpus):
    st, x = _mk_state(small_corpus)
    s0 = st.snapshot()
    st.insert(np.ones((1, x.shape[1])))
    assert st.snapshot() is s0
    st.publish()
    s1 = st.snapshot()
    assert s1.seq > s0.seq and s1.fill == 1
    assert int(s0.delta_ids[0]) == -1
    assert s1.delta_vecs.device.type == "cpu"


def test_state_delete_ignores_unminted_ids(small_corpus):
    st, x = _mk_state(small_corpus)
    n = x.shape[0]
    assert st.delete(np.asarray([0, 5, n + 50])) == 2
    assert st.delete(np.asarray([5])) == 0
    assert st.n_tombstoned == 2
    assert 0 < st.tombstone_frac < 1


def test_inserts_become_visible_through_search(small_corpus, port_index):
    st, x = _mk_state(small_corpus)
    pipe = _mk_pipe(port_index, st)
    eng, lane = _mk_engine(pipe, st)
    far = np.full((2, x.shape[1]), 7.5, np.float32)
    assert lane.submit_insert(far) > 0
    for _ in range(4):
        eng.submit(far[0], 5, index="idx")
    eng.step(now=1.0)
    comps = eng.qp.poll()
    assert len(comps) == 4
    n = x.shape[0]
    for c in comps:
        assert c.ids[0] == n
    vis = lane.visibility_stats()
    assert vis["n_visible"] == 1 and vis["n_pending"] == 0
    _, op, dt = lane.visible_log[0]
    assert op == "insert" and dt == 1.0 - 0.0


def test_tombstoned_main_and_delta_ids_filtered(small_corpus, port_index):
    st, x = _mk_state(small_corpus)
    pipe = _mk_pipe(port_index, st)
    eng, lane = _mk_engine(pipe, st)
    n = x.shape[0]
    far = np.full((2, x.shape[1]), 7.5, np.float32)
    lane.submit_insert(far)
    eng.submit(far[0], 5, index="idx")
    eng.step(now=0.5)
    (c0,) = eng.qp.poll()
    assert c0.ids[0] == n and n + 1 in c0.ids.tolist()
    victim_main = int(c0.ids[2])
    lane.submit_delete(np.asarray([n, victim_main]))
    eng.submit(far[0], 5, index="idx")
    eng.step(now=1.0)
    (c1,) = eng.qp.poll()
    ids1 = c1.ids.tolist()
    assert n not in ids1 and victim_main not in ids1
    assert n + 1 == ids1[0]


def test_update_storm_cannot_starve_search(small_corpus, port_index):
    st, x = _mk_state(small_corpus, capacity=512)
    pipe = _mk_pipe(port_index, st)
    eng, lane = _mk_engine(pipe, st)
    for _ in range(40):
        lane.submit_insert(np.zeros((1, x.shape[1])))
    served = 0
    for i in range(5):
        eng.submit(x[i], 5, index="idx")
        served += eng.step(now=float(i))
    assert served == 5
    assert lane.stats.applied_inserts == 4 * 5
    assert lane.qp.sq_len() == 20


def test_full_buffer_rejects_with_rebuild_due(small_corpus, port_index):
    st, x = _mk_state(small_corpus, capacity=4)
    pipe = _mk_pipe(port_index, st)
    eng, lane = _mk_engine(pipe, st)
    lane.submit_insert(np.zeros((3, x.shape[1])))
    lane.submit_insert(np.zeros((2, x.shape[1])))
    eng.step(now=0.0)
    comps = lane.qp.poll()
    assert [c.status for c in comps] == ["ok", "rebuild_due"]
    assert lane.stats.rejected_full == 1
    assert st.fill == 3


def test_update_lane_deadline_admission_and_covered_deletes(small_corpus):
    st, x = _mk_state(small_corpus)
    d = x.shape[1]
    vt = [0.0]
    lane = UpdateLane(st, clock=lambda: vt[0])
    lane.submit_insert(np.ones((1, d)), deadline_s=0.005)
    vt[0] = 0.02
    assert lane.pump(vt[0]) == 0
    c = lane.qp.poll()[0]
    assert c.status == "shed" and lane.stats.shed_deadline == 1
    assert st.fill == 0 and lane.stats.publishes == 0
    lane.submit_insert(np.ones((2, d)), deadline_s=0.05)
    assert lane.pump(vt[0]) == 1
    ok = lane.qp.poll()[0]
    assert ok.status == "ok" and st.fill == 2
    lane.submit_delete(ok.ids)
    lane.pump(vt[0])
    assert lane.qp.poll()[0].status == "ok"
    pubs = lane.stats.publishes
    lane.submit_delete(ok.ids)
    lane.pump(vt[0])
    c2 = lane.qp.poll()[0]
    assert c2.status == "covered"
    assert lane.stats.covered_deletes == 1
    assert lane.stats.publishes == pubs
    ids2 = st.insert(np.ones((1, d)))
    st.publish()
    lane.submit_delete(np.concatenate([ok.ids[:1], ids2]))
    lane.pump(vt[0])
    assert lane.qp.poll()[0].status == "ok"
    assert st.n_tombstoned == 3


def test_update_deadline_shed_counted_under_storm(small_corpus, port_index):
    st, x = _mk_state(small_corpus, capacity=512)
    vt = [0.0]
    pipe = _mk_pipe(port_index, st)
    lane = UpdateLane(st, clock=lambda: vt[0])
    policy = BatchPolicy(max_batch=16, max_wait_s=0.001, pad=8,
                         update_quantum=4)
    batcher = DynamicBatcher(policy, ["idx"])
    eng = ServeEngine({"idx": pipe}, batcher, clock=lambda: vt[0],
                      update_lanes={"idx": lane})
    for _ in range(12):
        lane.submit_insert(np.zeros((1, x.shape[1])), deadline_s=0.5)
    eng.submit(x[0], 5, index="idx")
    eng.step(now=0.0)
    vt[0] = 1.0
    eng.submit(x[1], 5, index="idx")
    eng.step(now=1.0)
    eng.submit(x[2], 5, index="idx")
    eng.step(now=1.0)
    assert lane.stats.applied_inserts == 4
    assert lane.stats.shed_deadline == 8
    assert st.fill == 4


def test_epoch_retires_only_after_last_inflight_harvest(small_corpus,
                                                        port_index):
    st, _ = _mk_state(small_corpus)
    pipe_a = _mk_pipe(port_index, st)
    pipe_b = _mk_pipe(port_index, st)
    vm = VersionManager(clock=lambda: 0.0)
    ep_a = vm.deploy("idx", pipe_a, fresh=st)
    held = vm.route("idx")
    assert held is ep_a and ep_a.inflight == 1
    old, new = vm.swap("idx", pipe_b, fresh=st)
    assert old is ep_a and old.retired
    assert not old.finalized.is_set()
    assert not pipe_a.tier.released
    assert vm.route("idx") is new
    new.release()
    vm.harvested(held)
    assert old.finalized.is_set()
    assert pipe_a.tier.released
    with pytest.raises(RuntimeError):
        pipe_a.tier.fetch(np.zeros((1, 2), np.int32))
    assert not pipe_b.tier.released


def test_engine_routes_through_version_manager(small_corpus, port_index):
    st, x = _mk_state(small_corpus)
    pipe = _mk_pipe(port_index, st)
    eng, _ = _mk_engine(pipe, st)
    vm = VersionManager(clock=lambda: 0.0)
    vm.deploy("idx", pipe, fresh=st)
    vm.bind(eng)
    for i in range(3):
        eng.submit(x[i], 5, index="idx")
    assert eng.step(now=0.0) == 3
    ep = vm.current("idx")
    assert ep.record.batches == 1 and ep.inflight == 0
