"""The port's mesh, sharding specs, collectives and distributed Lloyd step
on process groups (``repro_torch.launch.mesh``, ``distributed/sharding.py``,
``distributed/collectives.py``, ``build/kmeans.kmeans_sharded_step``),
against the JAX package.

Each multi-rank test spawns its ranks once (gloo on the CPU, a file
rendezvous, a timeout); the ranks import only ``torch`` and
``repro_torch`` and run ``repro_torch.launch.mesh_jobs`` (the launcher's
own checks from ``repro_torch.testing``).  The JAX oracles
run here.  Also the kernel library's build lock, which must serialise two
processes."""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import torch_threads  # noqa: E402,F401
import repro_torch.testing as checks  # noqa: E402
from repro_torch.launch import mesh_jobs  # noqa: E402
from repro_torch.launch.mesh import RankFailed, spawn  # noqa: E402

TIMEOUT_S = 120
AXES2 = ("data", "model")


def _spawn(world, jobs, timeout_s=TIMEOUT_S):
    return spawn(mesh_jobs.run, (world,), ("data",), backend="gloo",
                 device="cpu", args=(jobs,), timeout_s=timeout_s)


def _tree(seed=0):
    """The gradient tree of tests/test_multidevice.py part 4."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(32, 8)).astype(np.float32),
            "b": [rng.normal(size=(64,)).astype(np.float32)]}


# --------------------------------------------------------------------------
# quantization (in process)
# --------------------------------------------------------------------------
def test_quantize_roundtrip_error_bound(rng):
    """tests/test_distributed.py's round-trip bound on the port."""
    from repro_torch.distributed.collectives import dequantize_int8, \
        quantize_int8

    x = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs().max().item()
    assert err <= float(scale) * 0.5 + 1e-7


@pytest.mark.parametrize("shape,spread", [((64, 32), 1.0), ((4096,), 1e-3),
                                          ((17, 3), 300.0), ((8,), 0.0)])
def test_quantize_int8_bit_equal_to_reference(shape, spread):
    """Codes and scale bit-equal to the reference's (half to even, the
    1e-12 floor on an all-zero tensor)."""
    from repro.distributed.collectives import quantize_int8 as jquant
    from repro_torch.distributed.collectives import quantize_int8

    x = (np.random.default_rng(5).normal(size=shape) * spread).astype(
        np.float32)
    x.reshape(-1)[:2] = [0.5 * spread, -2.5 * spread]
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jquant(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()


def test_tree_flatten_follows_the_reference_order():
    """Leaves in jax.tree_util's order (dict keys sorted), and back."""
    from repro_torch.distributed.collectives import tree_flatten, \
        tree_unflatten

    tree = {"z": [np.int32(1), (np.int32(2), np.int32(3))],
            "a": {"y": np.int32(4), "b": np.int32(5)}}
    leaves, st = tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert tree_unflatten(st, leaves) == tree


def test_tree_flatten_and_unflatten_an_adamw_state():
    """A NamedTuple node (``AdamWState``) is rebuilt from its children as
    positional arguments, and its leaves come in the order
    ``jax.tree_util.tree_flatten`` gives the reference's ``adamw.init``."""
    from repro.optim import adamw
    from repro_torch.distributed.collectives import tree_flatten, \
        tree_unflatten
    from repro_torch.optim import AdamWState
    from repro_torch.optim import init as tinit

    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(3, 2)).astype(np.float32),
              "b": {"x": rng.normal(size=(2,)).astype(np.float32)}}
    tree = (params, tinit({"w": torch.from_numpy(params["w"]),
                           "b": {"x": torch.from_numpy(params["b"]["x"])}}))
    leaves, st = tree_flatten(tree)
    back = tree_unflatten(st, leaves)
    assert isinstance(back[1], AdamWState)
    assert back[1].step is tree[1].step
    ref = (params, adamw.init(jax.tree.map(jnp.asarray, params)))
    want = jax.tree_util.tree_leaves(ref)
    assert [tuple(np.shape(a)) for a in leaves] == [w.shape for w in want]
    assert [str(np.asarray(a).dtype) for a in leaves] == [
        str(w.dtype) for w in want]


# --------------------------------------------------------------------------
# collectives on process groups
# --------------------------------------------------------------------------
def test_compressed_psum_single_participant_with_error_feedback():
    """tests/test_distributed.py on the port at world 1: the value comes
    back up to quantization and the error buffer carries the residual."""
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    (res,) = _spawn(1, [{"kind": "collectives", "shape": (1, 1),
                         "tree": _tree(), "ef": x}])[0]
    out, err, out2 = res["ef"]
    np.testing.assert_allclose(out, x, atol=1e-2)
    e1 = np.abs(out - x).mean()
    e2 = np.abs((out + out2) / 2 - x).mean()
    assert e2 <= e1 + 1e-6
    np.testing.assert_allclose(err, x - out, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_compressed_and_bucketed_psum_match_the_plain_mean(shape):
    """tests/test_multidevice.py part 4 on the port, over the data axis:
    compressed (int8 with error feedback) within 3e-2 of the plain mean,
    bucketed (128-byte buckets) within 1e-5; every rank gets the same."""
    tree = _tree()
    out = _spawn(4, [{"kind": "collectives", "shape": shape,
                      "tree": tree, "bucket_bytes": 128}])
    n = shape[0]
    for (res,) in out:
        for got, want in zip(jax.tree.leaves(res["compressed"]),
                             jax.tree.leaves(tree)):
            np.testing.assert_allclose(got, want, atol=3e-2)
        for got, want in zip(jax.tree.leaves(res["bucketed"]),
                             jax.tree.leaves(tree)):
            # rank r along data held the tree x (r + 1)
            np.testing.assert_allclose(got, want * (n + 1) / 2, atol=1e-5)
        assert not res["host_staged"]


# --------------------------------------------------------------------------
# the distributed Lloyd step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_kmeans_sharded_step_matches_reference(tmp_path, fused):
    """kmeans_sharded_step at four ranks (rows over data, sums and counts
    all-reduced) against the reference's at mesh (1, 1): counts exact,
    centroids within 1e-5 (only the order of the sum differs)."""
    import repro  # noqa: F401  (jax.shard_map's shim)
    from repro.build.kmeans import kmeans_sharded_step as jstep
    from repro.core.distance import squared_l2 as jl2
    from repro.kernels.ops import kmeans_assign_update_tile

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(16, 12))[rng.integers(0, 16, 2048)]
         + 0.3 * rng.normal(size=(2048, 12))).astype(np.float32)
    cents = x[rng.choice(2048, 24, replace=False)].copy()
    cents[5] = 50.0                                 # an empty cluster
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "cents.npy", cents)
    (res,) = _spawn(4, [{"kind": "kmeans", "shape": (4, 1), "fused": fused,
                         "work": str(tmp_path)}])[0]
    want = jstep(jax.make_mesh((1, 1), AXES2), jnp.asarray(x),
                 jnp.asarray(cents), 24, fused=fused)
    if fused:
        counts = kmeans_assign_update_tile(jnp.asarray(x),
                                           jnp.asarray(cents))[3]
    else:
        a = jnp.argmin(jl2(jnp.asarray(x), jnp.asarray(cents)), axis=1)
        counts = jnp.bincount(a, length=24)
    np.testing.assert_array_equal(res["counts"], np.asarray(counts))
    assert res["counts"][5] == 0
    np.testing.assert_allclose(res["centroids"], np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(res["centroids"][5], cents[5])
    assert res["rows"] == 512


# --------------------------------------------------------------------------
# the row-sharded recsys tables
# --------------------------------------------------------------------------
RECSYS_ROWS = 2048


def test_recsys_sharded_embeddings_and_forward_match(tmp_path):
    """tests/test_multidevice.py part 2 on the port, one spawn of four gloo
    ranks: a 64 x 8 table and ids 16 x 5 in [-1, 64) on meshes (2, 2)
    (weighted) and (1, 4): ``embedding_bag_sharded`` within rtol and atol
    1e-5 (part 2's) of the reference's ``embedding_bag``,
    ``embedding_lookup_sharded`` bit-equal to the reference's lookup (a
    -0.0 entry and an empty slot included); on (2, 2), ``forward(mesh=...)`` of each
    recsys arch (tables of 2,048 rows, a batch of 32) within rtol 1e-5 of
    the port's unsharded forward on the same parameters."""
    import dataclasses

    from repro.models.recsys.embedding import embedding_bag, \
        embedding_lookup
    from repro_torch import ckpt
    from repro_torch.configs import get
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models import recsys as trs

    rng = np.random.default_rng(0)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    ids = rng.integers(-1, 64, size=(16, 5)).astype(np.int32)
    # a -0.0 entry must come back -0.0 and an empty slot +0.0
    table[7, 3] = -0.0
    ids[0, :2] = 7, -1
    weights = rng.uniform(0.5, 2.0, size=(16, 5)).astype(np.float32)
    archs = ["xdeepfm", "wide_deep", "mind", "din"]
    work = {}
    for tag, w in (("2x2", weights), ("1x4", None)):
        work[tag] = tmp_path / tag
        work[tag].mkdir()
        np.save(work[tag] / "table.npy", table)
        np.save(work[tag] / "ids.npy", ids)
        if w is not None:
            np.save(work[tag] / "weights.npy", w)
    want_logits = {}
    for i, name in enumerate(archs):
        cfg = dataclasses.replace(get(name).config, table_rows=RECSYS_ROWS)
        params = trs.init_params(cfg, torch.Generator().manual_seed(i))
        batch = recsys_batch(32, cfg.n_sparse, RECSYS_ROWS,
                             seq_len=cfg.seq_len, seed=i)
        ckpt.save(params, 0, str(work["2x2"] / f"{name}_params"))
        np.savez(work["2x2"] / f"{name}_batch.npz", **batch)
        with torch.no_grad():
            want_logits[name] = trs.forward(
                params, {k: torch.from_numpy(v) for k, v in batch.items()},
                cfg).numpy()
    out = _spawn(4, [
        {"kind": "recsys", "shape": (2, 2), "work": str(work["2x2"]),
         "embedding": True, "archs": archs, "rows": RECSYS_ROWS},
        {"kind": "recsys", "shape": (1, 4), "work": str(work["1x4"]),
         "embedding": True}], timeout_s=180)
    assert out[0][0]["files"] == sorted(["lookup", "bag"] + [
        f"{a}_logits" for a in archs])
    lookup = np.asarray(embedding_lookup(jnp.asarray(table),
                                         jnp.asarray(ids)))
    for tag, w in (("2x2", weights), ("1x4", None)):
        bag = np.asarray(embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                       None if w is None
                                       else jnp.asarray(w)))
        np.testing.assert_allclose(np.load(work[tag] / "bag.npy"), bag,
                                   rtol=1e-5, atol=1e-5, err_msg=tag)
        got = np.load(work[tag] / "lookup.npy")
        assert got.tobytes() == lookup.tobytes(), tag
    for name in archs:
        np.testing.assert_allclose(
            np.load(work["2x2"] / f"{name}_logits.npy"), want_logits[name],
            rtol=1e-5, atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------
# the mesh and the sharding specs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_subgroups_and_axis_indices(shape):
    """Row-major coordinates; each axis's subgroup holds the ranks that
    differ only along it, in axis order; make_host_mesh keeps the
    reference's shape and make_production_mesh refuses 4 ranks."""
    out = _spawn(4, [{"kind": checks.layout, "shape": shape,
                      "arrays": _layout_arrays(2)}])
    grid = np.arange(4).reshape(shape)
    for rank, (res,) in enumerate(out):
        d, m = np.unravel_index(rank, shape)
        assert res["coords"] == {"data": d, "model": m}
        assert res["indices"] == res["coords"]
        assert res["sizes"] == {"data": shape[0], "model": shape[1]}
        assert res["groups"]["data"] == grid[:, m].tolist()
        assert res["groups"]["model"] == grid[d, :].tolist()
        assert res["host_mesh"] == {"data": 2, "model": 2}
        assert "256" in res["production_error"]


def _layout_arrays(n_batch):
    rng = np.random.default_rng(1)
    return {"centroids": rng.normal(size=(8, 4)).astype(np.float32),
            "postings": rng.normal(size=(8, 3, 4)).astype(np.float32),
            "posting_ids": rng.integers(0, 99, (8, 3)).astype(np.int32),
            "llsp": np.zeros(5, np.float32),
            "queries": rng.normal(size=(4 * n_batch, 4)).astype(np.float32),
            "topk": rng.integers(1, 50, 4 * n_batch).astype(np.int32)}


@pytest.mark.parametrize("shape,axes", [
    ((2, 2), AXES2), ((1, 4), AXES2), ((2, 1, 2), ("pod", "data", "model"))],
    ids=["2x2", "1x4", "pod2x1x2"])
def test_shard_local_and_gather_axes_round_trip_every_anns_spec(shape,
                                                                 axes):
    """Every anns_specs entry cut with shard_local and rebuilt with
    gather_axes gives the global array back on every rank (queries over
    (pod, data) pod-major, posting arrays over model)."""
    arrays = _layout_arrays(4)
    out = _spawn(4, [{"kind": checks.layout, "shape": shape, "axes": axes,
                      "arrays": arrays}])
    for (res,) in out:
        assert set(res["rebuilt"]) == set(arrays)
        for name, want in arrays.items():
            np.testing.assert_array_equal(res["rebuilt"][name], want)


def test_shard_local_cuts_the_reference_blocks():
    """shard_local's block of each rank is the one jax's NamedSharding
    gives that device of a (2, 2) mesh (pod-less), in-process."""
    from repro_torch.distributed.sharding import P, shard_local

    class _M:
        axis_names = AXES2
        shape = {"data": 2, "model": 2}

        def __init__(self, d, m):
            self.c = {"data": d, "model": m}

        def size(self, a):
            return self.shape[a]

        def index(self, a):
            return self.c[a]

    x = np.arange(8 * 6).reshape(8, 6)
    for d in range(2):
        for m in range(2):
            mesh = _M(d, m)
            np.testing.assert_array_equal(
                shard_local(x, P(("data",), "model"), mesh),
                x[4 * d:4 * d + 4, 3 * m:3 * m + 3])
            np.testing.assert_array_equal(shard_local(x, P(), mesh), x)
            np.testing.assert_array_equal(
                shard_local(x, P(("data", "model")), mesh),
                x[2 * (2 * d + m):2 * (2 * d + m) + 2])
    with pytest.raises(ValueError):
        shard_local(np.arange(3), P("model"), _M(0, 0))


# --------------------------------------------------------------------------
# spawn's failure paths and the build lock
# --------------------------------------------------------------------------
def test_spawn_raises_when_a_rank_raises():
    """A rank that raises makes spawn raise its error at once (the others,
    stuck in a barrier, are stopped), well inside the timeout."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="boom") as info:
        _spawn(4, [{"kind": checks.fail, "shape": (1, 4), "rank": 2,
                    "msg": "boom"}], timeout_s=60)
    assert isinstance(info.value.__cause__, ValueError)
    assert time.monotonic() - t0 < 60


def test_spawn_raises_when_a_rank_does_not_finish(tmp_path):
    """A rank still running at the timeout makes spawn raise, and no child
    outlives the call."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="did not finish"):
        _spawn(1, [{"kind": checks.lock, "dir": str(tmp_path),
                    "hold_s": 600}], timeout_s=8)
    assert time.monotonic() - t0 < 60


def test_spawn_and_mesh_default_to_the_card():
    """Left out, ``device`` is this rank's card, for spawn and for a Mesh
    built in the rank: without CUDA the ranks refuse to start."""
    if torch.cuda.is_available():
        (res,) = spawn(mesh_jobs.run, (1,), ("data",), backend="gloo",
                       args=([{"kind": checks.devices}],), timeout_s=60)[0]
        assert res == ["cuda:0", "cuda:0"]
    else:
        with pytest.raises(RankFailed, match="CUDA is absent"):
            spawn(mesh_jobs.run, (1,), ("data",), backend="gloo",
                  args=([{"kind": checks.devices}],), timeout_s=60)


def test_build_lock_serialises_processes(tmp_path):
    """Two processes that take the kernel library's build lock at once hold
    it one after the other."""
    out = _spawn(2, [{"kind": checks.lock, "dir": str(tmp_path),
                      "hold_s": 0.5}])
    (a0, a1), (b0, b1) = (r[0] for r in out)
    assert a1 <= b0 or b1 <= a0, ((a0, a1), (b0, b1))
    assert os.path.exists(tmp_path / "lock")
