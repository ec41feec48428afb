"""The port's recsys family (``repro_torch.models.recsys``, ``configs``,
``data/synthetic.py``'s model feeds and ``examples/train_retrieval_torch.py``)
against the JAX package, on identical numpy inputs.

Every case of tests/test_models_recsys.py runs on the port.  With the
reference's parameters carried over (``convert.params_tree``; the two
packages draw different random initialisations): each arch's logits within
rtol 1e-5 / atol 1e-6, one step's loss and gradients within rtol 1e-4 /
atol 1e-6, a 6-step loss trajectory within rtol 1e-4; ``capsule_routing``
within rtol 1e-5; the parameters and first moments after one step within
atol 1e-5; ``retrieval_scores`` ids equal (ties lowest index first,
as ``lax.top_k``).  The synthetic feeds and the example's
``make_structured_batch`` are byte-equal to the reference's.
"""
import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import STEP_PARAM_ATOL, torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.data.synthetic import recsys_batch as t_recsys_batch  # noqa: E402
from repro_torch.models import recsys as trs  # noqa: E402
from repro_torch.models.recsys.models import capsule_routing as t_capsule  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RS_ARCHS = ["xdeepfm", "wide_deep", "mind", "din"]


def _example(name: str):
    """Load ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reduced(name):
    return dataclasses.replace(tget(name).config, table_rows=2048)


def _ref_cfg(name):
    from repro.configs import get

    return dataclasses.replace(get(name).config, table_rows=2048)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=RS_ARCHS)
def model(request):
    """The port's reduced config, its own seeded params and a batch: the
    fixture of tests/test_models_recsys.py."""
    cfg = _reduced(request.param)
    params = trs.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = t_recsys_batch(32, cfg.n_sparse, cfg.table_rows,
                           seq_len=cfg.seq_len, seed=1)
    return request.param, cfg, params, _torch_batch(batch)


@pytest.fixture(scope="module", params=RS_ARCHS)
def carried(request):
    """The reference's params (PRNGKey(0)) and batch, as numpy, with the
    port's copy of the params."""
    from repro.models.recsys import init_params

    name = request.param
    rcfg = _ref_cfg(name)
    rparams = jax.jit(lambda k: init_params(rcfg, k))(jax.random.PRNGKey(0))
    batch = t_recsys_batch(32, rcfg.n_sparse, rcfg.table_rows,
                           seq_len=rcfg.seq_len, seed=1)
    return (name, rcfg, rparams, batch,
            convert.params_tree(_np_tree(rparams), device="cpu"))


# --------------------------------------------------------------------------
# tests/test_models_recsys.py on the port
# --------------------------------------------------------------------------
def test_forward_shapes_finite(model):
    name, cfg, params, batch = model
    logits = trs.forward(params, batch, cfg)
    assert logits.shape == (32,)
    assert bool(torch.isfinite(logits).all()), name


def test_train_step_improves(model):
    name, cfg, params, batch = model
    step = trs.make_train_step(cfg)
    opt = tadamw.init(params)
    losses = []
    for _ in range(6):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], (name, losses)


def test_embedding_bag_matches_manual(rng):
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(-1, 50, size=(6, 5)).astype(np.int32)
    out = trs.embedding_bag(torch.from_numpy(table),
                            torch.from_numpy(ids)).numpy()
    for b in range(6):
        want = table[ids[b][ids[b] >= 0]].sum(0) if (ids[b] >= 0).any() \
            else 0
        np.testing.assert_allclose(out[b], want, rtol=1e-5, atol=1e-6)


def test_embedding_bag_weights(rng):
    table = rng.normal(size=(20, 4)).astype(np.float32)
    ids = np.array([[0, 1, -1]], dtype=np.int32)
    w = np.array([[2.0, 0.5, 9.9]], dtype=np.float32)
    out = trs.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out[0], 2 * table[0] + 0.5 * table[1],
                               rtol=1e-5)


def test_embedding_lookup_masks_negatives(rng):
    table = rng.normal(size=(10, 3)).astype(np.float32)
    ids = np.array([[1, -1], [0, 2]], dtype=np.int32)
    out = trs.embedding_lookup(torch.from_numpy(table),
                               torch.from_numpy(ids)).numpy()
    assert (out[0, 1] == 0).all()
    np.testing.assert_array_equal(out[1, 1], table[2])


def test_retrieval_scores_single_and_multi_interest(rng):
    cand = rng.normal(size=(100, 8)).astype(np.float32)
    user = rng.normal(size=(2, 8)).astype(np.float32)
    _, ids = trs.retrieval_scores(torch.from_numpy(user),
                                  torch.from_numpy(cand), k=5)
    want = user @ cand.T
    for b in range(2):
        np.testing.assert_array_equal(ids.numpy()[b],
                                      np.argsort(-want[b])[:5])
    multi = rng.normal(size=(2, 3, 8)).astype(np.float32)
    _, ids = trs.retrieval_scores(torch.from_numpy(multi),
                                  torch.from_numpy(cand), k=5)
    want = np.einsum("bid,nd->bin", multi, cand).max(1)
    for b in range(2):
        np.testing.assert_array_equal(ids.numpy()[b],
                                      np.argsort(-want[b])[:5])


def test_capsule_routing_output_norms():
    """Squash keeps interest capsule norms in (0, 1)."""
    cfg = _reduced("mind")
    rng = np.random.default_rng(0)
    hist = torch.from_numpy(rng.normal(size=(4, cfg.seq_len, cfg.embed_dim))
                            .astype(np.float32))
    mask = torch.ones((4, cfg.seq_len), dtype=torch.bool)
    bil = torch.from_numpy(rng.normal(size=(cfg.embed_dim, cfg.embed_dim))
                           .astype(np.float32) * 0.1)
    v = t_capsule(hist, mask, bil, cfg)
    assert v.shape == (4, cfg.n_interests, cfg.embed_dim)
    norms = np.linalg.norm(v.numpy(), axis=-1)
    assert (norms < 1.0 + 1e-5).all() and (norms > 0).all()


# --------------------------------------------------------------------------
# the port against the reference, on carried parameters
# --------------------------------------------------------------------------
def test_logits_match_reference(carried):
    from repro.models.recsys import forward

    name, rcfg, rparams, batch, tparams = carried
    want = np.asarray(jax.jit(lambda p, b: forward(p, b, rcfg))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = trs.forward(tparams, _torch_batch(batch), _reduced(name)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=name)


def test_loss_and_gradients_match_reference(carried):
    """One step's loss and every parameter's gradient, through all three
    routing iterations for MIND and the sigmoid attention MLP for DIN."""
    from repro.models.recsys import bce_loss
    from repro_torch.distributed.collectives import tree_flatten, \
        tree_unflatten

    name, rcfg, rparams, batch, tparams = carried
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: bce_loss(p, b, rcfg)))(rparams, jb)
    leaves, st = tree_flatten(tparams)
    live = [p.clone().requires_grad_(True) for p in leaves]
    loss = trs.bce_loss(tree_unflatten(st, live), _torch_batch(batch),
                        _reduced(name))
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-4,
                               err_msg=name)
    want_leaves = jax.tree_util.tree_leaves(want_g)
    assert len(want_leaves) == len(grads)
    for g, w in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_one_step_params_match_reference(carried):
    from repro.models.recsys import make_train_step
    from repro.optim import adamw
    from repro_torch.distributed.collectives import tree_flatten

    name, rcfg, rparams, batch, tparams = carried
    jp, jo, _ = jax.jit(make_train_step(rcfg))(
        rparams, adamw.init(rparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp, to, _ = trs.make_train_step(_reduced(name))(
        tparams, tadamw.init(tparams), _torch_batch(batch))
    for got, want in ((tp, jp), (to.mu, jo.mu)):
        for g, w in zip(tree_flatten(got)[0], jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=STEP_PARAM_ATOL, err_msg=name)


def test_loss_trajectory_matches_reference(carried):
    """Six train steps (AdamW, default config of make_train_step) from the
    same params on the same batch: the losses within rtol 1e-4."""
    from repro.models.recsys import make_train_step
    from repro.optim import adamw

    name, rcfg, rparams, batch, tparams = carried
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(make_train_step(rcfg))
    jp, jo = rparams, adamw.init(rparams)
    tstep = trs.make_train_step(_reduced(name))
    tp, to = tparams, tadamw.init(tparams)
    tb = _torch_batch(batch)
    want, got = [], []
    for _ in range(6):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)
    assert int(to.step) == int(jo.step) == 6


def test_capsule_routing_matches_reference():
    from repro.models.recsys.models import capsule_routing

    rcfg, cfg = _ref_cfg("mind"), _reduced("mind")
    rng = np.random.default_rng(3)
    hist = rng.normal(size=(8, cfg.seq_len, cfg.embed_dim)).astype(np.float32)
    mask = np.arange(cfg.seq_len)[None, :] < rng.integers(
        1, cfg.seq_len + 1, size=(8, 1))
    bil = (rng.normal(size=(cfg.embed_dim, cfg.embed_dim)) * 0.2).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda h, m, b: capsule_routing(h, m, b, rcfg))(
        jnp.asarray(hist), jnp.asarray(mask), jnp.asarray(bil)))
    got = t_capsule(torch.from_numpy(hist), torch.from_numpy(mask),
                    torch.from_numpy(bil), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_retrieval_scores_ids_equal_reference(multi):
    """Ids equal to lax.top_k's, ties included: every candidate appears
    three times, so each score is tied and the lowest index must win."""
    from repro.models.recsys import retrieval_scores

    rng = np.random.default_rng(4)
    cand = np.repeat(rng.normal(size=(40, 8)).astype(np.float32), 3, axis=0)
    user = rng.normal(size=(3, 2, 8) if multi else (3, 8)).astype(np.float32)
    wv, wi = retrieval_scores(jnp.asarray(user), jnp.asarray(cand), k=20)
    gv, gi = trs.retrieval_scores(torch.from_numpy(user),
                                  torch.from_numpy(cand), k=20)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6)


def test_param_shapes_specs_and_init_scale():
    """param_shapes on the meta device with the reference's shapes and
    tree; param_specs the reference's; init_params' scale rule (0.05 below
    rank 2, else 1/sqrt(shape[-2]))."""
    from repro.models.recsys import param_shapes, param_specs
    from repro_torch.distributed.collectives import tree_flatten_with_path

    for name in RS_ARCHS:
        cfg, rcfg = _reduced(name), _ref_cfg(name)
        got = tree_flatten_with_path(trs.param_shapes(cfg))
        want = jax.tree_util.tree_flatten_with_path(param_shapes(rcfg))[0]
        assert [tuple(p) for p, _ in got] == [
            tuple(getattr(k, "key", k) for k in p) for p, _ in want]
        for (_, t), (_, s) in zip(got, want):
            assert t.device.type == "meta" and tuple(t.shape) == s.shape
        specs = trs.param_specs(cfg)
        rspecs = param_specs(rcfg)
        assert specs["table"] == tuple(rspecs["table"])
        params = trs.init_params(cfg, torch.Generator().manual_seed(1))
        table = params["table"]
        assert table.shape == (2048, cfg.embed_dim)
        np.testing.assert_allclose(float(table.std()),
                                   1 / np.sqrt(cfg.table_rows), rtol=0.05)
        for path, leaf in tree_flatten_with_path(params):
            if leaf.dim() < 2 and leaf.numel() > 100:
                np.testing.assert_allclose(float(leaf.std()), 0.05,
                                           rtol=0.2, err_msg=str(path))


def test_configs_match_reference():
    """The five ported configs carry the reference's published widths; an
    LM or GNN arch raises, naming ROADMAP item 3; the shape sets agree."""
    from repro import configs as rconfigs
    from repro_torch import configs as tconfigs

    for name in RS_ARCHS + ["helmsman"]:
        got, want = tconfigs.get(name), rconfigs.get(name)
        assert (got.name, got.family, got.source) == (want.name, want.family,
                                                      want.source)
        gf = dataclasses.asdict(got.config)
        wf = dataclasses.asdict(want.config)
        gf.pop("dtype", None), wf.pop("dtype", None)
        assert gf == wf, name
        assert {k: dataclasses.astuple(v) for k, v in got.shapes.items()} \
            == {k: dataclasses.astuple(v) for k, v in want.shapes.items()}
    assert tconfigs.ARCH_NAMES == rconfigs.ARCH_NAMES
    for sub in (False, True):
        gs, gk = tconfigs.lm_shapes(sub_quadratic=sub)
        ws, wk = rconfigs.lm_shapes(sub_quadratic=sub)
        assert gk == wk and {k: dataclasses.astuple(v)
                             for k, v in gs.items()} == {
            k: dataclasses.astuple(v) for k, v in ws.items()}
    for name in ("qwen2_moe", "graphcast"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
            tconfigs.get(name)
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        tconfigs.all_archs()


def test_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        trs.make_train_step(_reduced("mind"), mesh=object())


# --------------------------------------------------------------------------
# the synthetic feeds and the example's click logs
# --------------------------------------------------------------------------
def _same_bytes(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_bytes(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_bytes(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("feed", ["recsys", "recsys_seq", "token", "graph",
                                  "neighbor"])
def test_synthetic_feeds_byte_equal(feed):
    from repro.data import synthetic as rsyn
    from repro_torch.data import synthetic as tsyn

    calls = {
        "recsys": lambda m: m.recsys_batch(64, 39, 1 << 24, seed=3),
        "recsys_seq": lambda m: m.recsys_batch(64, 4, 1 << 22, seq_len=100,
                                               seed=4),
        "token": lambda m: m.token_batch(8, 129, 50_000, seed=5),
        "graph": lambda m: m.random_graph(512, 2048, 32, seed=6),
        "neighbor": lambda m: m.neighbor_sample(
            *m.random_graph(300, 1500, 4, seed=7)[:2],
            np.array([3, 9, 9, 41]), (5, 3),
            rng=np.random.default_rng(8)),
    }
    _same_bytes(calls[feed](tsyn), calls[feed](rsyn))


def test_structured_batch_byte_equal():
    ref = _example("train_retrieval")
    twin = _example("train_retrieval_torch")
    for seed in (0, 999):
        _same_bytes(twin.make_structured_batch(256, 8192, 20, seed=seed),
                    ref.make_structured_batch(256, 8192, 20, seed=seed))


def test_train_retrieval_twin_reaches_its_probe_ceiling():
    """The example twin's flow on the CPU: train, build over the learned
    table, serve the interest vectors; an exact f32 scan must reach the
    probe ceiling."""
    twin = _example("train_retrieval_torch")
    out = twin.run(types.SimpleNamespace(steps=20, items=1024, device="cpu"))
    assert np.isfinite(out["final_loss"])
    assert out["n_clusters"] > 1
    assert 0 < out["recall"] <= 1
    assert abs(out["recall"] - out["ceiling"]) <= 1e-6
    assert 0 < out["scanned_frac"] <= 1
