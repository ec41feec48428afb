"""The port's GraphCast (``repro_torch.models.gnn``) against the JAX
package on identical numpy inputs, with the reference's parameters carried
over by ``convert.params_tree``: every case of tests/test_models_gnn.py
(the full graph's training, the edge mask against dropped edges, the
batched molecules, the sampled subgraph with a node mask, row-DP against
the dense forward), each also held to the reference, plus
``segment_sum``/``segment_max`` (empty segments included) and
``forward_rowdp`` over four gloo ranks.

Tolerances: forwards within rtol and atol 1e-5; one train step's loss
within rtol 1e-5 and its parameters within ``STEP_PARAM_ATOL``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import STEP_PARAM_ATOL, torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.data.synthetic import random_graph  # noqa: E402
from repro_torch.distributed.collectives import tree_flatten, \
    tree_map  # noqa: E402
from repro_torch.launch import mesh_jobs  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models.gnn import graphcast as tgc  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cfgs():
    """tests/test_models_gnn.py's reduced config in both packages."""
    from repro.configs import get

    kw = dict(n_layers=3, d_hidden=32, n_vars=7)
    return (dataclasses.replace(get("graphcast").config, **kw),
            dataclasses.replace(tget("graphcast").config, **kw))


def _params(rc, d_feat, seed=0):
    from repro.models.gnn import init_params

    rp = init_params(rc, d_feat, jax.random.PRNGKey(seed))
    return rp, convert.params_tree(_np(rp), device="cpu")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_param_shapes_specs_and_init_rule(cfgs):
    from jax.sharding import PartitionSpec

    from repro.models.gnn import graphcast as rgc

    rc, tc = cfgs
    want = {tuple(k.key for k in p): tuple(s.shape) for p, s in
            jax.tree_util.tree_flatten_with_path(rgc.param_shapes(rc, 9))[0]}
    from repro_torch.distributed.collectives import tree_flatten_with_path

    got = {p: tuple(s.shape) for p, s in
           tree_flatten_with_path(tgc.param_shapes(tc, 9))}
    assert got == want
    for row_dp in (False, True):
        r = rgc.param_specs(dataclasses.replace(rc, row_dp=row_dp))
        t = tgc.param_specs(dataclasses.replace(tc, row_dp=row_dp))
        flat_r = {tuple(k.key for k in p): tuple(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(
                      r, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}
        flat_t = {}

        def walk(tree, path=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    flat_t[path + (k,)] = tuple(v)
        walk(t)
        assert flat_t == flat_r
    p = tgnn.init_params(tc, 9, torch.Generator().manual_seed(0), "cpu")
    assert bool((p["proc"]["ln_node"] == 1).all())
    assert bool((p["encoder"]["b1"] == 0).all())
    std = float(p["proc"]["edge_w1"].std())
    assert abs(std - 1 / np.sqrt(64)) < 0.1 / np.sqrt(64)


def test_full_graph_forward_and_train_match(cfgs, rng):
    """tests/test_models_gnn.py's full-graph training: the forward, one
    step and a 5-step loss trajectory (falling) against the reference."""
    from repro.models.gnn import forward, make_train_step
    from repro.optim import adamw as radamw

    rc, tc = cfgs
    src, dst, feats = random_graph(100, 400, 16, seed=0)
    tgt = rng.normal(size=(100, 7)).astype(np.float32)
    rp, tp = _params(rc, 16)
    want = np.asarray(forward(rp, jnp.asarray(feats), jnp.asarray(src),
                              jnp.asarray(dst), rc))
    got = tgnn.forward(tp, *_t(feats, src, dst), tc)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    rb = {"node_feats": jnp.asarray(feats), "src": jnp.asarray(src),
          "dst": jnp.asarray(dst), "targets": jnp.asarray(tgt)}
    tb = dict(zip(("node_feats", "src", "dst", "targets"),
                  _t(feats, src, dst, tgt)))
    rstep, tstep = jax.jit(make_train_step(rc)), tgnn.make_train_step(tc)
    ropt, topt = radamw.init(rp), tadamw.init(tp)
    rl, tl = [], []
    for i in range(5):
        rp, ropt, rm = rstep(rp, ropt, rb)
        tp, topt, tm = tstep(tp, topt, tb)
        rl.append(float(rm["loss"]))
        tl.append(float(tm["loss"]))
        if i == 0:
            for g, w in zip(tree_flatten(tp)[0], jax.tree.leaves(rp)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                           atol=STEP_PARAM_ATOL)
    np.testing.assert_allclose(tl, rl, rtol=1e-4)
    assert tl[-1] < tl[0] and np.isfinite(tl[-1])


def test_edge_mask_equals_dropping_edges(cfgs, rng):
    from repro.models.gnn import forward

    rc, tc = cfgs
    src, dst, feats = random_graph(50, 120, 8, seed=1)
    keep = rng.random(120) > 0.3
    rp, tp = _params(rc, 8)
    full = tgnn.forward(tp, *_t(feats, src, dst), tc,
                        edge_mask=torch.from_numpy(keep))
    sub = tgnn.forward(tp, *_t(feats, src[keep], dst[keep]), tc)
    np.testing.assert_allclose(full.detach().numpy(),
                               sub.detach().numpy(), rtol=1e-4, atol=1e-4)
    want = forward(rp, jnp.asarray(feats), jnp.asarray(src),
                   jnp.asarray(dst), rc, edge_mask=jnp.asarray(keep))
    np.testing.assert_allclose(full.detach().numpy(), np.asarray(want),
                               **TOL)


def test_batched_molecules_match(cfgs, rng):
    """forward_batched (the graphs' node ids offset into one flat graph)
    against the reference's vmap, with and without an edge mask."""
    from repro.models.gnn import forward_batched

    rc, tc = cfgs
    b, n, e = 8, 12, 20
    feats = rng.normal(size=(b, n, 5)).astype(np.float32)
    src = rng.integers(0, n, size=(b, e)).astype(np.int32)
    dst = rng.integers(0, n, size=(b, e)).astype(np.int32)
    mask = rng.random((b, e)) > 0.2
    rp, tp = _params(rc, 5)
    for m in (None, mask):
        got = tgnn.forward_batched(
            tp, *_t(feats, src, dst), tc,
            None if m is None else torch.from_numpy(m))
        want = forward_batched(rp, jnp.asarray(feats), jnp.asarray(src),
                               jnp.asarray(dst), rc,
                               None if m is None else jnp.asarray(m))
        assert got.shape == (b, n, tc.n_vars)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_sampled_subgraph_step_matches(cfgs, rng):
    """The minibatch_lg regime: a padded sampled subgraph, the edge mask
    and the seed nodes' loss (node_mask): three steps against the
    reference's."""
    from repro.models.gnn import make_train_step
    from repro.optim import adamw as radamw
    from repro_torch.data.synthetic import neighbor_sample

    rc, tc = cfgs
    src, dst, feats = random_graph(300, 3000, 16, seed=3)
    seeds = rng.choice(300, size=32, replace=False).astype(np.int32)
    layers, _ = neighbor_sample(src, dst, seeds, fanouts=(5, 3))
    es = np.concatenate([l[0] for l in layers])
    ed = np.concatenate([l[1] for l in layers])
    target = -(-len(es) // 128) * 128
    pad = target - len(es)
    es, ed = np.pad(es, (0, pad)), np.pad(ed, (0, pad))
    emask = np.arange(target) < (target - pad)
    nmask = np.zeros(300, bool)
    nmask[seeds] = True
    tgt = rng.normal(size=(300, 7)).astype(np.float32)
    arrays = {"node_feats": feats, "src": es, "dst": ed, "edge_mask": emask,
              "targets": tgt, "node_mask": nmask}
    rb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in arrays.items()}
    rp, tp = _params(rc, 16)
    want = float(jax.jit(lambda p, b: __import__(
        "repro.models.gnn", fromlist=["mse_loss"]).mse_loss(
        p, b["node_feats"], b["src"], b["dst"], b["targets"], rc,
        b["edge_mask"], b["node_mask"]))(rp, rb))
    got = float(tgnn.mse_loss(tp, tb["node_feats"], tb["src"], tb["dst"],
                              tb["targets"], tc, tb["edge_mask"],
                              tb["node_mask"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    rstep, tstep = jax.jit(make_train_step(rc)), tgnn.make_train_step(tc)
    ropt, topt = radamw.init(rp), tadamw.init(tp)
    for _ in range(3):
        rp, ropt, rm = rstep(rp, ropt, rb)
        tp, topt, tm = tstep(tp, topt, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   rtol=1e-4)
    assert np.isfinite(float(tm["loss"]))


def test_segment_sum_and_max_follow_jax(rng):
    """Out-of-range ids dropped, empty segments 0 (sum) and -inf (max)."""
    m = rng.normal(size=(40, 3)).astype(np.float32)
    ids = rng.integers(-2, 12, size=40).astype(np.int32)
    for tfn, jfn in ((tgc.segment_sum, jax.ops.segment_sum),
                     (tgc.segment_max, jax.ops.segment_max)):
        got = tfn(*_t(m, ids), 14).numpy()
        want = np.asarray(jfn(jnp.asarray(m), jnp.asarray(ids),
                              num_segments=14))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert np.isneginf(got[13]).all() if tfn is tgc.segment_max \
            else (got[13] == 0).all()


def test_max_aggregator_matches(cfgs):
    from repro.models.gnn import forward

    rc, tc = cfgs
    rc = dataclasses.replace(rc, aggregator="max")
    tc = dataclasses.replace(tc, aggregator="max")
    src, dst, feats = random_graph(30, 300, 4, seed=5)   # every node fed
    rp, tp = _params(rc, 4)
    got = tgnn.forward(tp, *_t(feats, src, dst), tc).detach().numpy()
    want = np.asarray(forward(rp, jnp.asarray(feats), jnp.asarray(src),
                              jnp.asarray(dst), rc))
    np.testing.assert_allclose(got, want, **TOL)


def _rowdp_graph(n, e, shards, seed):
    rng = np.random.default_rng(seed)
    rows, per = n // shards, e // shards
    dst = np.concatenate([rng.integers(r * rows, (r + 1) * rows, size=per)
                          for r in range(shards)]).astype(np.int32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order], rng.normal(size=(n, 8)).astype(np.float32)


def test_forward_rowdp_matches_the_dense_forward(cfgs, tmp_path):
    """forward_rowdp at four gloo ranks (mesh (1, 4) and (2, 2)) on
    dst-sorted edges, each rank's edges in its row range, with an edge
    mask: equal to the port's dense forward and to the reference's
    (tests/test_models_gnn.py's rtol and atol 2e-4)."""
    from repro.models.gnn import forward

    rc, tc = cfgs
    tc = dataclasses.replace(tc, row_dp=True)
    src, dst, feats = _rowdp_graph(64, 256, 4, seed=7)
    emask = np.random.default_rng(8).random(256) > 0.1
    rp, tp = _params(rc, 8)
    torch.save(tp, tmp_path / "gnn.pt")
    for name, a in (("node_feats", feats), ("src", src), ("dst", dst),
                    ("edge_mask", emask)):
        np.save(tmp_path / f"{name}.npy", a)
    jobs = [{"kind": "gnn_rowdp", "work": str(tmp_path), "cfg": tc,
             "params": "gnn", "out": f"rowdp{i}", "shape": shape}
            for i, shape in enumerate(((1, 4), (2, 2)))]
    spawn(mesh_jobs.run, (4,), ("data",), backend="gloo", device="cpu",
          args=(jobs,), timeout_s=120)
    dense = tgnn.forward(tp, *_t(feats, src, dst), tc,
                         edge_mask=torch.from_numpy(emask)).detach().numpy()
    want = np.asarray(forward(rp, jnp.asarray(feats), jnp.asarray(src),
                              jnp.asarray(dst), rc,
                              edge_mask=jnp.asarray(emask)))
    for i in range(2):
        got = np.load(tmp_path / f"rowdp{i}.npy")
        np.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_mesh_paths_not_ported_are_refused(cfgs):
    """The mesh paths are ported (tests/test_torch_mesh_train.py); given a
    mesh they take the global arrays as DTensors and refuse plain
    tensors."""
    from repro_torch.optim import adamw as tadamw

    _, tc = cfgs
    sharded = dataclasses.replace(tc, sharded_mp=True)
    p = tgnn.init_params(tc, 4, torch.Generator().manual_seed(0), "cpu")
    src, dst, feats = random_graph(10, 20, 4, seed=0)
    feats_t, src_t, dst_t = _t(feats, src, dst)
    batch = {"node_feats": feats_t, "src": src_t, "dst": dst_t,
             "targets": torch.zeros((10, tc.n_vars))}
    with pytest.raises(TypeError, match="DTensor"):
        tgnn.make_train_step(tc, mesh=object())(p, tadamw.init(p), batch)
    with pytest.raises(TypeError, match="DTensor"):
        tgnn.forward(p, feats_t, src_t, dst_t, sharded, mesh=object())


def test_segment_sum_repeats_bit_for_bit(rng):
    """The CPU's ordered scatter-add: two runs, and a step's gradient
    through the gathers, bit-equal."""
    m = torch.from_numpy(rng.normal(size=(20000, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 500, size=20000))
    a, b = tgc.segment_sum(m, ids, 500), tgc.segment_sum(m, ids, 500)
    assert torch.equal(a, b)
    _, tc = (None, dataclasses.replace(tget("graphcast").config, n_layers=2,
                                       d_hidden=16, n_vars=3))
    p = tgnn.init_params(tc, 4, torch.Generator().manual_seed(1), "cpu")
    src, dst, feats = random_graph(200, 5000, 4, seed=2)
    batch = dict(zip(("node_feats", "src", "dst"), _t(feats, src, dst)))
    batch["targets"] = torch.zeros((200, 3))
    step = tgnn.make_train_step(tc)
    x = step(p, tadamw.init(p), batch)[0]
    y = step(p, tadamw.init(p), batch)[0]
    assert all(torch.equal(u, v) for u, v in zip(tree_flatten(x)[0],
                                                 tree_flatten(y)[0]))
    assert tree_map(lambda t: t.dtype, x)["proc"]["edge_w1"] == torch.float32
