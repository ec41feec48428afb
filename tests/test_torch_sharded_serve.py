"""The port's sharded engines (``make_sharded_serve``,
``make_sharded_serve_quantized``) on process-group meshes, against the JAX
package.

Each test spawns its ranks once (``repro_torch.launch.mesh.spawn``: gloo on
the CPU, a file rendezvous, a timeout), hands them the index as ``.npy``
files under ``tmp_path`` and compares what rank 0 returns with oracles that
the JAX package computes here.  The ranks import only ``torch`` and
``repro_torch``; the scans run their kernels' plain versions.

The corpus and index are those of ``tests/test_multidevice.py`` part 1
(2,000 x 16 normal rows, 32 queries, clusters of at most 40, closure eps
0.2, 48 slots, clusters padded to a multiple of 4 with centroids at 1e6 and
ids -1), built by the port on the CPU and given to both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_candidates_match, torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.launch import mesh_jobs  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

TIMEOUT_S = 120
MESHES = [(2, 2), (1, 4)]
FLAT = dict(k=10, nprobe_max=16, pruning="none", use_kernel=False)


def _pad(cents, postings, pids, mult):
    """Clusters padded to a multiple of ``mult``: centroids at 1e6, empty
    postings, ids -1 (as tests/test_multidevice.py pads them)."""
    c, l, d = postings.shape
    cp = -(-c // mult) * mult
    return (np.concatenate([cents, np.full((cp - c, d), 1e6, np.float32)]),
            np.concatenate([postings, np.zeros((cp - c, l, d), np.float32)]),
            np.concatenate([pids, np.full((cp - c, l), -1, np.int32)]))


@pytest.fixture(scope="module")
def case():
    """(x, queries, padded centroids, postings, ids, q8, scale, norm2, LLSP
    params of the port)."""
    from repro_torch.build.kmeans import balanced_hierarchical_kmeans
    from repro_torch.build.pipeline import train_llsp_for_index
    from repro_torch.core.ivf import IVFIndex, build_postings
    from repro_torch.core.llsp import LLSPConfig
    from repro_torch.core.quantize import quantize_postings
    from repro_torch.core.spann_rules import closure_assign

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 16)).astype(np.float32)
    q = rng.normal(size=(32, 16)).astype(np.float32)
    cents, _ = balanced_hierarchical_kmeans(x, 40, iters=6, device="cpu")
    ca = closure_assign(torch.from_numpy(x), torch.from_numpy(cents),
                        eps=0.2).numpy()
    postings, pids = build_postings(x, ca, cents.shape[0], 48)
    cents, postings, pids = _pad(cents, postings, pids, 4)
    qp = quantize_postings(torch.from_numpy(postings),
                           torch.from_numpy(cents))
    tindex = IVFIndex(torch.from_numpy(cents), torch.from_numpy(postings),
                      torch.from_numpy(pids))
    llsp = train_llsp_for_index(
        LLSPConfig(levels=(8, 16), n_ratio_features=8, n_trees=20,
                   max_depth=4), tindex, x, q, np.full(len(q), 10, np.int32))
    return {"x": x, "queries": q, "centroids": cents, "postings": postings,
            "posting_ids": pids, "q8": qp.q8.numpy(),
            "qscale": qp.scale.numpy(), "qnorm2": qp.norm2.numpy(),
            "llsp": llsp}


def _write(tmp_path, case, topk=10):
    for name in ("queries", "centroids", "postings", "posting_ids", "q8",
                 "qscale", "qnorm2"):
        np.save(tmp_path / f"{name}.npy", case[name])
    np.save(tmp_path / "topk.npy",
            np.full(len(case["queries"]), topk, np.int32))
    mesh_jobs.save_llsp(str(tmp_path / "llsp.npz"), case["llsp"])
    return str(tmp_path)


def _serve_jobs(work, shape, engines):
    """One serve job per (engine, cfg) on a ``shape`` mesh, all queries in
    one global batch."""
    return [{"kind": "serve", "shape": shape, "work": work, "engine": e,
             "cfg": cfg, "batch": 32} for e, cfg in engines]


def _run(work, shape, engines):
    world = shape[0] * shape[1]
    out = spawn(mesh_jobs.run, (world,), ("data",), backend="gloo",
                device="cpu", args=(_serve_jobs(work, shape, engines),),
                timeout_s=TIMEOUT_S)
    return out[0]


def _jindex(case):
    from repro.core.ivf import IVFIndex as JIndex

    return JIndex(jnp.asarray(case["centroids"]),
                  jnp.asarray(case["postings"]),
                  jnp.asarray(case["posting_ids"]))


def _jqp(case):
    from repro.core.quantize import QuantizedPostings

    return QuantizedPostings(q8=jnp.asarray(case["q8"]),
                             scale=jnp.asarray(case["qscale"]),
                             norm2=jnp.asarray(case["qnorm2"]))


def _close_ids(got, want, max_diff=2):
    for a, b in zip(got, want):
        assert len(set(a.tolist()) ^ set(b.tolist())) <= max_diff, (a, b)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_search_matches_search_flat(case, tmp_path, shape):
    """tests/test_multidevice.py part 1 on the port: the f32 engine at four
    ranks (queries over data, clusters over model) == the reference's
    search_flat."""
    from repro.core.ivf import search_flat

    work = _write(tmp_path, case)
    (res,) = _run(work, shape, [("f32", FLAT)])
    d_fl, i_fl = search_flat(_jindex(case), jnp.asarray(case["queries"]),
                             10, nprobe=16)
    np.testing.assert_allclose(res["dists"], np.asarray(d_fl), rtol=1e-4,
                               atol=1e-4)
    _close_ids(res["ids"], np.asarray(i_fl))
    assert (res["nprobe"] == 16).all()


@pytest.mark.parametrize("shape", [(1, 1), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_q8_sharded_engine_matches_flat(case, tmp_path, shape):
    """tests/test_quantize.py's q8 sharded engine on the port, at one rank
    and at four: == the reference's search_flat_quantized."""
    from repro.core.quantize import search_flat_quantized

    work = _write(tmp_path, case)
    (res,) = _run(work, shape, [("q8", FLAT)])
    d_fl, i_fl = search_flat_quantized(_jindex(case), _jqp(case),
                                       jnp.asarray(case["queries"]), 10, 16)
    np.testing.assert_allclose(res["dists"], np.asarray(d_fl), rtol=1e-4,
                               atol=1e-4)
    _close_ids(res["ids"], np.asarray(i_fl))


@pytest.mark.parametrize("engine,tol", [("f32", 1e-5), ("q8", 1e-4)])
def test_sharded_engine_fused_matches_legacy(case, tmp_path, engine, tol):
    """tests/test_fused_topk.py's sharded cases on the port (one rank):
    the candidate-compressed scan == the legacy (B, P, L) path."""
    work = _write(tmp_path, case)
    legacy, fused = _run(work, (1, 1), [
        (engine, dict(FLAT, fused_topk=False)),
        (engine, dict(FLAT, fused_topk=True))])
    np.testing.assert_allclose(fused["dists"], legacy["dists"], rtol=tol,
                               atol=tol)
    for a, b in zip(fused["ids"], legacy["ids"]):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize("shape", [(1, 1), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_shard_centroids_matches_replicated(case, tmp_path, shape):
    """tests/test_search_extras.py's shard_centroids case on the port: the
    sharded centroid scan (per-shard slice, (B, nmax) all-gather, re-rank)
    == the replicated scan."""
    work = _write(tmp_path, case)
    off, on = _run(work, shape, [
        ("f32", dict(FLAT, shard_centroids=False)),
        ("f32", dict(FLAT, shard_centroids=True))])
    np.testing.assert_allclose(on["dists"], off["dists"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(on["nprobe"], off["nprobe"])


@pytest.mark.parametrize("engine", ["f32", "q8"])
def test_sharded_engines_match_reference_at_one_rank(case, tmp_path,
                                                     engine):
    """The port at world 1 against the reference's own sharded engine on
    jax.make_mesh((1, 1)), with LLSP pruning over the same (converted)
    params: ids equal up to ties, nprobe equal."""
    from repro.core.gbdt import GBDTParams as JGBDT
    from repro.core.llsp import LLSPParams as JLLSP
    from repro.core.search import SearchConfig as JCfg
    from repro.core.search import make_sharded_serve as jmake
    from repro.core.search import make_sharded_serve_quantized as jmake_q8

    work = _write(tmp_path, case)
    cfg = dict(FLAT, pruning="llsp", n_ratio=8)
    (res,) = _run(work, (1, 1), [(engine, cfg)])
    llsp = case["llsp"]
    jg = lambda g: JGBDT(**convert.gbdt_arrays(g))
    jllsp = JLLSP(jg(llsp.router), jg(llsp.pruners),
                  jnp.asarray(llsp.levels.numpy()))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    q = jnp.asarray(case["queries"])
    tk = jnp.full((q.shape[0],), 10, jnp.int32)
    if engine == "f32":
        d, i, npb = jax.jit(jmake(mesh, JCfg(**cfg)))(
            jnp.asarray(case["centroids"]), jnp.asarray(case["postings"]),
            jnp.asarray(case["posting_ids"]), jllsp, q, tk)
    else:
        qp = _jqp(case)
        d, i, npb = jax.jit(jmake_q8(mesh, JCfg(**cfg)))(
            jnp.asarray(case["centroids"]), qp.q8, qp.scale, qp.norm2,
            jnp.asarray(case["posting_ids"]), jllsp, q, tk)
    np.testing.assert_array_equal(res["nprobe"], np.asarray(npb))
    assert_candidates_match(res["dists"], res["ids"], np.asarray(d),
                            np.asarray(i),
                            tol=1e-4 if engine == "f32" else 1e-3)


def test_sharded_engine_specs_follow_the_reference():
    """The engines' in_specs/out_specs are the reference's shard_map specs
    (centroids replicated or sliced, posting arrays over model, queries and
    outputs over the batch axes)."""
    from repro_torch.core.search import SearchConfig, make_sharded_serve, \
        make_sharded_serve_quantized
    from repro_torch.distributed.sharding import P

    class _M:                        # the specs read no group
        def size(self, axis):
            return 1

        def index(self, axis):
            return 0

        def group(self, axis):
            return None

    b = P(("pod", "data"))
    for sc, cent in ((False, P()), (True, P("model"))):
        fn = make_sharded_serve(_M(), SearchConfig(shard_centroids=sc),
                                batch_axes=("pod", "data"))
        assert fn.in_specs == (cent, P("model"), P("model"), P(), b, b)
        assert fn.out_specs == (b, b, b)
    fn = make_sharded_serve_quantized(_M(), SearchConfig())
    assert fn.in_specs == (P("model"),) * 5 + (P(), P(("data",)),
                                               P(("data",)))
    assert SearchConfig().shard_centroids is False
