"""The port's LM family (``repro_torch.models.lm``), its configs and specs,
against the JAX package on identical numpy inputs.

Every LM arch runs at ``scaled_lm_config(., 0.02)`` with ``q_chunk`` 16 in
float32, from the reference's parameters carried over by
``convert.params_tree`` (the two packages draw different initialisations):
``forward``, ``loss_fn``, one train step, ``prefill_step`` (logits and
caches) and a 12-step ``decode_step`` loop.  One small config also runs in
bfloat16.

Tolerances.  Both packages run the reference's parameters with the
attention projections rescaled to their contracted fan-in (``contracted``;
the reference's rule puts attention scores at ~50, where a one-ulp
float32 difference in a score moves a probability by ~1e-5 of itself).
Then hidden states, logits and caches agree within 1e-5 of the largest
magnitude of the reference's output, the loss and the gradient norm within
rtol 1e-5, and after one AdamW step the moments within 1e-5 of the
largest moment and every parameter within ``STEP_PARAM_ATOL`` of the
reference's beyond ``adamw_step_gap``: the part of the difference that the
step's own update g / (|g| + eps) makes of the two gradients' difference
where |g| is near eps (measured on this CPU: 1.33e-5 at one w_up element
of gemma3-12b whose gradient is 5.2e-9 against 6.3e-9, every other
element within 8e-6).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import STEP_PARAM_ATOL, adamw_step_gap, \
    torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed.collectives import tree_flatten, \
    tree_flatten_with_path  # noqa: E402
from repro_torch.launch.train import scaled_lm_config as t_scaled  # noqa: E402
from repro_torch.models.lm import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

LM_ARCHS = ["gemma3_12b", "phi4_mini", "gemma3_27b", "llama4_scout",
            "qwen2_moe"]
LM_GNN = LM_ARCHS + ["graphcast"]
# the largest |port - reference| over the largest |reference| of an
# output (module doc)
TOL = 1e-5
TOKENS = (2, 33)
DECODE_STEPS = 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _configs(name, scale=0.02, **kw):
    from repro.configs import get as rget
    from repro.launch.train import scaled_lm_config as r_scaled

    rc = dataclasses.replace(r_scaled(rget(name).config, scale), **kw)
    tc = dataclasses.replace(t_scaled(tconfigs.get(name).config, scale),
                             **kw)
    return rc, tc


def _fields(cfg) -> dict:
    """A config's fields with dtypes by name and nested configs as dicts."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif f.name == "dtype":
            v = np.dtype(v).name if not isinstance(v, torch.dtype) \
                else str(v).replace("torch.", "")
        out[f.name] = v
    return out


# --------------------------------------------------------------------------
# configs, shapes and specs
# --------------------------------------------------------------------------
def test_every_arch_is_registered():
    from repro import configs as rconfigs

    archs = tconfigs.all_archs()
    assert len(archs) == 11
    assert [a.name for a in archs] == [a.name for a in rconfigs.all_archs()]


@pytest.mark.parametrize("name", LM_GNN)
def test_config_equals_the_reference(name):
    from repro import configs as rconfigs

    got, want = tconfigs.get(name), rconfigs.get(name)
    assert (got.name, got.family, got.source, got.skip_shapes) == \
        (want.name, want.family, want.source, want.skip_shapes)
    assert _fields(got.config) == _fields(want.config)
    assert {k: dataclasses.astuple(v) for k, v in got.shapes.items()} == \
        {k: dataclasses.astuple(v) for k, v in want.shapes.items()}


@pytest.mark.parametrize("scale", [0.02, 0.05])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_scaled_lm_config_matches(name, scale):
    rc, tc = _configs(name, scale)
    assert _fields(tc) == _fields(rc)


def _shapes(tree_with_path) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for path, leaf in tree_with_path}


@pytest.mark.parametrize("name", LM_ARCHS)
def test_param_and_cache_shapes_match(name):
    from repro.configs import get as rget
    from repro.models.lm import transformer as rtf

    for rc, tc in ((rget(name).config, tconfigs.get(name).config),
                   _configs(name)):
        want = _shapes(jax.tree_util.tree_flatten_with_path(
            rtf.param_shapes(rc))[0])
        got = _shapes(tree_flatten_with_path(ttf.param_shapes(tc)))
        assert got == want
        assert (tc.n_params, tc.n_active_params) == (rc.n_params,
                                                     rc.n_active_params)
        want = _shapes(jax.tree_util.tree_flatten_with_path(
            rtf.cache_shapes(rc, 3, 1500))[0])
        got = _shapes(tree_flatten_with_path(ttf.cache_shapes(tc, 3, 1500)))
        assert got == want
    assert all(t.device.type == "meta"
               for t in tree_flatten(ttf.param_shapes(tc))[0])


def _entry(e):
    """A spec entry with a one-axis tuple as the axis name (JAX's
    PartitionSpec reads ('data',) as 'data')."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _spec_tuples(tree) -> dict:
    """{path: tuple} of a spec tree (the reference's PartitionSpecs or the
    port's P)."""
    if isinstance(tree, dict):
        return {(k,) + p: v for k in tree
                for p, v in _spec_tuples(tree[k]).items()}
    return {(): tuple(_entry(e) for e in tree)}


class _StubMesh:
    """The axis names and sizes the spec functions read."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))

    def size(self, axis):
        return self.shape[axis]


@pytest.mark.parametrize("name", LM_ARCHS)
def test_specs_match(name):
    from jax.sharding import PartitionSpec

    from repro.configs import get as rget
    from repro.distributed import sharding as rsh
    from repro.models.lm import transformer as rtf
    from repro_torch.distributed import sharding as tsh

    rc, tc = rget(name).config, tconfigs.get(name).config
    for tp in (16, 4):
        for fsdp in (None, True, False):
            assert _spec_tuples(ttf.param_specs(tc, tp, fsdp)) == \
                _spec_tuples(rtf.param_specs(rc, tp, fsdp))
        assert _spec_tuples(ttf._pure_dp_specs(tc, tp)) == \
            _spec_tuples(rtf._pure_dp_specs(rc, tp))
    pure_r = dataclasses.replace(rc, pure_dp=True)
    pure_t = dataclasses.replace(tc, pure_dp=True)
    assert _spec_tuples(ttf.param_specs(pure_t)) == \
        _spec_tuples(rtf.param_specs(pure_r))
    want = rsh.lm_param_specs(rtf.param_shapes(rc), None)
    got = tsh.lm_param_specs(ttf.param_shapes(tc), None)
    flat_w = {tuple(str(k.key) for k in p): _spec_tuples(v)[()]
              for p, v in jax.tree_util.tree_flatten_with_path(
                  want, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}
    flat_g = _spec_tuples(got)
    assert flat_g == flat_w
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        rmesh = types.SimpleNamespace(axis_names=axes,
                                      shape=dict(zip(axes, shape)))
        tmesh = _StubMesh(shape, axes)
        for seq_shard in (True, False):
            assert _spec_tuples(ttf.cache_specs(tc, tmesh,
                                                seq_shard=seq_shard)) == \
                _spec_tuples(rtf.cache_specs(rc, rmesh,
                                             seq_shard=seq_shard))
        for kv, split in ((tc.n_kv, False), (16, False), (16, True)):
            assert _spec_tuples(tsh.lm_kv_cache_spec(
                tmesh, kv, seq_split=split)) == _spec_tuples(
                    rsh.lm_kv_cache_spec(rmesh, kv, seq_split=split))
        assert _spec_tuples(tsh.gnn_specs(tmesh)) == \
            _spec_tuples(rsh.gnn_specs(rmesh))


# --------------------------------------------------------------------------
# the five archs, scaled, float32: one reference run per arch
# --------------------------------------------------------------------------
def _ref_init(rc, seed):
    from repro.models.lm import transformer as rtf

    return jax.jit(rtf.init_params, static_argnums=0)(
        rc, jax.random.PRNGKey(seed))


def contracted(tree: dict, cfg) -> dict:
    """The reference's numpy parameters with the attention projections
    rescaled to normal / sqrt(the contracted dim), the rescale
    ``chip_smoke.py``'s ``contracted_fan_in`` applies on the card: the
    reference's rule takes shape[-2] as the fan-in, which for wq (D, H, Dh)
    is H, so that its attention scores reach ~50 and a one-ulp float32
    difference in a score moves a probability by ~1e-5 of itself.  Both
    packages then run the same rescaled arrays."""
    h, kv, d = cfg.heads_padded, cfg.n_kv, cfg.d_model
    scale = {"wq": np.sqrt(h / d), "wk": np.sqrt(kv / d),
             "wv": np.sqrt(kv / d), "wo": np.sqrt(1.0 / h)}
    out = dict(tree)
    for group in ("layers", "tail"):
        if out.get(group) is not None:
            out[group] = {k: (v * scale[k]).astype(v.dtype) if k in scale
                          else v for k, v in out[group].items()}
    return out


def _params(rc, seed):
    """(the reference's params on JAX, the same arrays in the port)."""
    arrays = contracted(_np(_ref_init(rc, seed)), rc)
    return (jax.tree.map(jnp.asarray, arrays),
            convert.params_tree(arrays, device="cpu"))


def outputs(name):
    """The reference's and the port's outputs on the same parameters and
    tokens: forward, loss, one train step, prefill, 12 decode steps (each
    reference function jitted once)."""
    from repro.models.lm import transformer as rtf
    from repro.optim import adamw as radamw

    rc, tc = _configs(name, q_chunk=16)
    rp, tp = _params(rc, 0)
    toks = np.random.default_rng(7).integers(
        0, rc.vocab, size=TOKENS).astype(np.int32)
    tt = torch.from_numpy(toks)

    @jax.jit
    def ref_outputs(p, toks):
        return (rtf.forward(p, toks[:, :-1], rc), rtf.loss_fn(p, toks, rc),
                rtf.prefill_step(p, toks[:, :16], rc))

    h, loss, (rl, rcache) = _np(ref_outputs(rp, jnp.asarray(toks)))
    ref = {"h": h, "loss": float(loss), "prefill": (rl, rcache)}
    got = {"h": ttf.forward(tp, tt[:, :-1], tc).numpy(),
           "loss": float(ttf.loss_fn(tp, tt, tc))}
    tl, tcache = ttf.prefill_step(tp, tt[:, :16], tc)
    got["prefill"] = (tl.numpy(), {k: v.numpy() for k, v in tcache.items()})
    rp2, ropt, rm = jax.jit(rtf.make_train_step(rc))(
        rp, radamw.init(rp), jnp.asarray(toks))
    tp2, topt, tm = ttf.make_train_step(tc)(tp, tadamw.init(tp), tt)
    ref["step"] = (_np(rp2), _np(ropt.mu), _np(ropt.nu), float(rm["loss"]),
                   float(rm["grad_norm"]))
    got["step"] = (tp2, topt.mu, topt.nu, float(tm["loss"]),
                   float(tm["grad_norm"]))
    dec = jax.jit(lambda p, c, t, i: rtf.decode_step(p, c, t, i, rc))
    rcache = rtf.init_cache(rc, TOKENS[0], DECODE_STEPS)
    tcache = ttf.init_cache(tc, TOKENS[0], DECODE_STEPS, device="cpu")
    ref["decode"], got["decode"] = [], []
    for t in range(DECODE_STEPS):
        lr_, rcache = dec(rp, rcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        lt_, tcache = ttf.decode_step(tp, tcache, tt[:, t], t, tc)
        ref["decode"].append(np.asarray(lr_))
        got["decode"].append(lt_.numpy())
    ref["cache"] = _np(rcache)
    got["cache"] = {k: v.numpy() for k, v in tcache.items()}
    return name, ref, got


@pytest.fixture(scope="module", params=LM_ARCHS)
def run(request):
    return outputs(request.param)


def test_forward_matches(run):
    name, ref, got = run
    assert got["h"].shape == ref["h"].shape
    assert rel(got["h"], ref["h"]) < TOL, name


def test_loss_matches(run):
    name, ref, got = run
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=TOL)


def test_train_step_matches(run):
    name, ref, got = run
    rp2, rmu, rnu, rloss, rgn = ref["step"]
    tp2, tmu, tnu, tloss, tgn = got["step"]
    np.testing.assert_allclose(tloss, rloss, rtol=TOL)
    np.testing.assert_allclose(tgn, rgn, rtol=TOL)
    leaves = lambda tree: [t.numpy() for t in tree_flatten(tree)[0]]
    g_mu, g_nu = leaves(tmu), leaves(tnu)
    w_mu, w_nu = jax.tree.leaves(rmu), jax.tree.leaves(rnu)
    for got_m, want_m, what in ((g_mu, w_mu, "mu"), (g_nu, w_nu, "nu")):
        scale = max(float(np.abs(w).max()) for w in want_m)
        err = max(float(np.abs(g - w).max()) for g, w in zip(got_m, want_m))
        assert err <= TOL * scale, (name, what, err, scale)
    g_leaves, w_leaves = tree_flatten(tp2)[0], jax.tree.leaves(rp2)
    assert len(g_leaves) == len(w_leaves)
    for g, w, gm, gv, wm, wv in zip(g_leaves, w_leaves, g_mu, g_nu, w_mu,
                                    w_nu):
        assert str(g.dtype).replace("torch.", "") == np.dtype(w.dtype).name
        excess = np.abs(g.numpy() - w) - adamw_step_gap(gm, gv, wm, wv)
        assert excess.max() <= STEP_PARAM_ATOL, (name, excess.max())


def test_prefill_matches(run):
    name, ref, got = run
    (rl, rcache), (tl, tcache) = ref["prefill"], got["prefill"]
    assert tl.shape == rl.shape and tl.dtype == np.float32
    assert rel(tl, rl) < TOL, name
    assert sorted(tcache) == sorted(rcache)
    for k in rcache:
        assert tcache[k].shape == rcache[k].shape, k
        assert rel(tcache[k], rcache[k]) < TOL, (name, k)


def test_decode_loop_matches(run):
    name, ref, got = run
    for t, (g, w) in enumerate(zip(got["decode"], ref["decode"])):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert rel(g, w) < TOL, (name, t)
    for k in ref["cache"]:
        assert rel(got["cache"][k], ref["cache"][k]) < TOL, k


def test_decode_rings_wrap_as_the_reference():
    """Past the window the local rings wrap (slot = pos % w, floor
    modulo) and the tail-local layers keep their own rings: gemma3-27b's
    scaled config with a window of 4 over 12 decode steps."""
    from repro.models.lm import transformer as rtf

    rc, tc = _configs("gemma3_27b", q_chunk=16, window=4)
    rp, tp = _params(rc, 3)
    toks = np.random.default_rng(8).integers(0, rc.vocab, size=(1, 12))
    rcache = rtf.init_cache(rc, 1, 12)
    tcache = ttf.init_cache(tc, 1, 12, device="cpu")
    assert tcache["k_l"].shape[3] == 4 and tcache["k_t"].shape[2] == 4
    dec = jax.jit(lambda p, c, t, i: rtf.decode_step(p, c, t, i, rc))
    for t in range(12):
        lr_, rcache = dec(rp, rcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        lt_, tcache = ttf.decode_step(tp, tcache,
                                      torch.from_numpy(toks[:, t]), t, tc)
        assert rel(lt_.numpy(), lr_) < TOL, t
    # a prefill of 10 tokens rolls its last 4 into ring order
    rl, rpc = jax.jit(lambda p, t: rtf.prefill_step(p, t, rc))(
        rp, jnp.asarray(toks[:, :10]))
    tl, tpc = ttf.prefill_step(tp, torch.from_numpy(toks[:, :10]), tc)
    assert rel(tl.numpy(), np.asarray(rl)) < TOL
    for k in ("k_l", "k_t"):
        assert rel(tpc[k].numpy(), np.asarray(rpc[k])) < TOL, k


def test_bf16_forward_and_decode_match():
    """phi4-mini scaled, in bfloat16 on both sides (the reference's bf16
    params, rescaled as ``contracted`` does, carried through their int16
    view): the loss within rtol 1e-4 (measured 1.3e-5) and the logits of
    prefill and decode within 5e-2 of their scale (the reference's own
    bf16 decode tolerance; measured 8.1e-3), after 8 bf16 rounding points
    a layer taken at the same places."""
    from repro.models.lm import transformer as rtf

    rc, tc = _configs("phi4_mini", q_chunk=16)
    rc = dataclasses.replace(rc, dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    arrays = contracted(_np(rtf.init_params(rc, jax.random.PRNGKey(0))), rc)
    rp = jax.tree.map(jnp.asarray, arrays)
    tp = convert.params_tree(arrays, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert rp["layers"]["wq"].dtype == jnp.bfloat16
    assert torch.equal(tp["layers"]["wq"].view(torch.int16),
                       torch.from_numpy(np.array(rp["layers"]["wq"]).view(
                           np.int16)))
    toks = np.random.default_rng(9).integers(0, rc.vocab, size=(2, 17))
    np.testing.assert_allclose(
        float(ttf.loss_fn(tp, torch.from_numpy(toks), tc)),
        float(rtf.loss_fn(rp, jnp.asarray(toks), rc)), rtol=1e-4)
    rl, _ = rtf.prefill_step(rp, jnp.asarray(toks[:, :16]), rc)
    tl, _ = ttf.prefill_step(tp, torch.from_numpy(toks[:, :16]), tc)
    assert rel(tl.numpy(), np.asarray(rl, np.float32)) < 5e-2
    rcache = rtf.init_cache(rc, 2, 4)
    tcache = ttf.init_cache(tc, 2, 4, device="cpu")
    for t in range(4):
        lr_, rcache = rtf.decode_step(rp, rcache, jnp.asarray(toks[:, t]),
                                      jnp.int32(t), rc)
        lt_, tcache = ttf.decode_step(tp, tcache,
                                      torch.from_numpy(toks[:, t]), t, tc)
        assert rel(lt_.numpy(), np.asarray(lr_)) < 5e-2, t


def test_init_params_follow_the_reference_rule():
    """Every leaf is drawn or set by the reference's rule (normal /
    sqrt(shape[-2]) where rank >= 2 and the last dim > 1, ones elsewhere
    and for the norms), one layer slice at a time, from the generator."""
    _, tc = _configs("gemma3_27b")
    gen = torch.Generator().manual_seed(0)
    p = ttf.init_params(tc, gen, "cpu")
    again = ttf.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    for (path, leaf), other in zip(tree_flatten_with_path(p),
                                   tree_flatten(again)[0]):
        assert torch.equal(leaf, other)
        if path[-1] in ("rms1", "rms2", "final_norm"):
            assert bool((leaf == 1).all()), path
        elif leaf.dim() >= 2 and leaf.shape[-1] > 1:
            std = float(leaf.float().std())
            want = 1.0 / np.sqrt(leaf.shape[-2])
            assert abs(std - want) < 0.2 * want, (path, std, want)
    assert p["layers"]["wq"].shape[:2] == (tc.n_blocks, tc.period)


def test_chunked_loss_and_attention_fall_back_to_one_chunk():
    """A sequence that q_chunk does not divide runs as one chunk (the
    reference's fallback): the same loss as q_chunk = S."""
    _, tc = _configs("phi4_mini", q_chunk=16)
    p = ttf.init_params(tc, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab, size=(2, 21)))
    a = ttf.loss_fn(p, toks, tc)
    b = ttf.loss_fn(p, toks, dataclasses.replace(tc, q_chunk=20))
    assert torch.equal(a, b)


def test_mesh_training_is_refused():
    """A mesh step (tests/test_torch_mesh_train.py) takes the global
    arrays as DTensors: plain tensors are refused."""
    _, tc = _configs("phi4_mini")
    p = ttf.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 9), dtype=torch.int32)
    with pytest.raises(TypeError, match="DTensor"):
        ttf.make_train_step(tc, mesh=object())(p, tadamw.init(p), toks)
