"""The port's MoE FFN (``repro_torch.models.lm.moe``) against the JAX
package on identical numpy inputs: the capacity-drop case of
tests/test_models_lm.py, a router whose probabilities all tie (the same
tokens win: lowest expert index first, then entry order), padded experts
that the router never picks, the auxiliary loss, and expert parallelism
over four gloo ranks at meshes (1, 4) and (2, 2) (with FSDP on the
latter) against ``forward(mesh=None)`` and against the reference, by
part 3 of tests/test_multidevice.py (rtol and atol 2e-3).

In float32 a single MoE layer agrees with the reference within rtol and
atol 1e-5; the combine adds each token's K outputs in the order the
reference's scatter meets them."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.launch import mesh_jobs  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.lm import moe as tmoe  # noqa: E402
from repro_torch.models.lm import transformer as ttf  # noqa: E402

TIMEOUT_S = 120


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(**moe_kw):
    """The same tiny MoE LM config in both packages (float32)."""
    from repro.models.lm import LMConfig, MoEConfig

    kw = dict(n_experts=4, top_k=1, d_ff_expert=16, n_shared=1,
              d_ff_shared=16)
    kw.update(moe_kw)
    lm = dict(name="t", n_layers=1, d_model=16, n_heads=2, n_kv=1, d_ff=0,
              vocab=32, q_chunk=8)
    rc = LMConfig(moe=MoEConfig(**kw), dtype=jnp.float32, **lm)
    tc = ttf.LMConfig(moe=tmoe.MoEConfig(**kw), dtype=torch.float32, **lm)
    return rc, tc


def _layer(rp):
    return jax.tree.map(lambda a: a[0, 0], rp["layers"])


def _moe_both(rc, tc, rp, x):
    from repro.models.lm.moe import moe_ffn as ref_moe_ffn

    want = np.asarray(ref_moe_ffn(jnp.asarray(x), _layer(rp), rc.moe, None))
    lp = convert.params_tree(_np(_layer(rp)), device="cpu")
    got = tmoe.moe_ffn(torch.from_numpy(x), lp, tc.moe, None).numpy()
    return got, want


def test_capacity_drop_keeps_residual_and_matches():
    """tests/test_models_lm.py:115: capacity_factor 0.26 drops most
    tokens; dropped tokens still flow through the residual and the shared
    expert, and the layer equals the reference's."""
    from repro.models.lm import init_params
    from repro.models.lm.transformer import forward as ref_forward

    rc, tc = _pair(capacity_factor=0.26)
    rp = init_params(rc, jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 9), 0,
                                         32))
    h = ttf.forward(convert.params_tree(_np(rp), device="cpu"),
                    torch.from_numpy(toks), tc)
    assert bool(torch.isfinite(h).all())
    np.testing.assert_allclose(
        h.numpy(), np.asarray(ref_forward(rp, jnp.asarray(toks), rc)),
        rtol=1e-5, atol=1e-5)
    x = np.random.default_rng(0).normal(size=(2, 9, 16)).astype(np.float32)
    got, want = _moe_both(rc, tc, rp, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    capacity = int(np.ceil(18 * 1 / 4 * 0.26))
    assert capacity == 2                 # 2 of 18 tokens an expert at most


@pytest.mark.parametrize("top_k", [1, 2])
def test_tied_router_picks_as_the_reference(top_k):
    """A zero router: every probability ties, so top-k takes the lowest
    expert ids and the capacity race keeps the first tokens; the same
    tokens win as in the reference."""
    from repro.models.lm import init_params
    from repro.models.lm.moe import moe_ffn as ref_moe_ffn

    rc, tc = _pair(top_k=top_k, capacity_factor=0.5)
    rp = init_params(rc, jax.random.PRNGKey(2))
    rp["layers"]["moe_router"] = jnp.zeros_like(rp["layers"]["moe_router"])
    x = np.random.default_rng(1).normal(size=(2, 8, 16)).astype(np.float32)
    _, top_p, top_e = tmoe.router(torch.from_numpy(x),
                                  {"moe_router": torch.zeros(16, 4)}, tc.moe)
    assert (top_e.reshape(-1, top_k) == torch.arange(top_k)).all()
    assert torch.allclose(top_p, torch.full_like(top_p, 1.0 / top_k))
    got, want = _moe_both(rc, tc, rp, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # which tokens reached the experts: the routed part without the shared
    lp = convert.params_tree(_np(_layer(rp)), device="cpu")
    no_shared = {k: v for k, v in lp.items() if not k.startswith("w_")}
    routed = tmoe.moe_ffn(torch.from_numpy(x), no_shared,
                          dataclasses.replace(tc.moe, n_shared=0), None)
    ref_routed = ref_moe_ffn(
        jnp.asarray(x), {k: v for k, v in _layer(rp).items()
                         if not k.startswith("w_")},
        dataclasses.replace(rc.moe, n_shared=0), None)
    won = routed.abs().sum(-1) > 0
    np.testing.assert_array_equal(won.numpy(),
                                  np.abs(np.asarray(ref_routed)).sum(-1) > 0)
    # every token picks experts 0..K-1; each keeps its capacity's first
    # tokens (2 for K = 1, 4 for K = 2), the same ones for every expert
    assert int(won.sum()) == {1: 2, 2: 4}[top_k]
    assert bool(won.reshape(-1)[:int(won.sum())].all())


def test_padded_experts_are_never_chosen():
    """e_pad > n_experts: the padded experts' logits are -1e30, so even a
    router that favours them never picks them; the layer equals the
    reference's."""
    from repro.models.lm import init_params

    rc, tc = _pair(n_experts=6, e_pad=8, top_k=2, capacity_factor=4.0)
    rp = init_params(rc, jax.random.PRNGKey(3))
    router = np.asarray(rp["layers"]["moe_router"]).copy()
    router[..., 6:] += 100.0
    rp["layers"]["moe_router"] = jnp.asarray(router)
    x = np.random.default_rng(2).normal(size=(2, 8, 16)).astype(np.float32)
    _, _, top_e = tmoe.router(torch.from_numpy(x),
                              {"moe_router": torch.from_numpy(router[0, 0])},
                              tc.moe)
    assert int(top_e.max()) < 6
    got, want = _moe_both(rc, tc, rp, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_load_balance_loss_matches():
    from repro.models.lm.moe import load_balance_loss as ref_lbl

    _, tc = _pair(n_experts=6, e_pad=8)
    rc, _ = _pair(n_experts=6, e_pad=8)
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 5, 8)).astype(np.float32)
    top_e = rng.integers(0, 6, size=(2, 5, 2)).astype(np.int32)
    got = tmoe.load_balance_loss(torch.from_numpy(logits),
                                 torch.from_numpy(top_e), tc.moe)
    want = ref_lbl(jnp.asarray(logits), jnp.asarray(top_e), rc.moe)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_one_layer_matches_the_reference_in_float32():
    """qwen2-moe's scaled layer (60 experts padded to 64, top-4, 4
    shared) on 2 x 33 tokens at the config's capacity."""
    from repro.configs import get
    from repro.launch.train import scaled_lm_config
    from repro.models.lm import init_params
    from repro_torch.configs import get as tget
    from repro_torch.launch.train import scaled_lm_config as t_scaled

    rc = scaled_lm_config(get("qwen2_moe").config, 0.05)
    tc = t_scaled(tget("qwen2_moe").config, 0.05)
    rp = init_params(rc, jax.random.PRNGKey(5))
    x = np.random.default_rng(5).normal(size=(2, 33, rc.d_model)).astype(
        np.float32)
    got, want = _moe_both(rc, tc, rp, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _ep_config(fsdp: bool):
    """tests/test_multidevice.py part 3's config."""
    from repro.models.lm import LMConfig, MoEConfig

    kw = dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
              d_ff_shared=32, capacity_factor=4.0)
    lm = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv=2, d_ff=0,
              vocab=64, q_chunk=16, fsdp=fsdp)
    return (LMConfig(moe=MoEConfig(**kw), dtype=jnp.float32, **lm),
            ttf.LMConfig(moe=tmoe.MoEConfig(**kw), dtype=torch.float32,
                         **lm))


def test_expert_parallel_matches_one_rank_and_the_reference(tmp_path):
    """forward(mesh=...) on four gloo ranks at (1, 4) and at (2, 2) with
    FSDP (each rank its experts, and its d_ff block gathered), and
    moe_ffn of one layer at (1, 4): equal to forward(mesh=None) and to
    the reference's (rtol and atol 2e-3)."""
    from repro.models.lm import init_params
    from repro.models.lm.transformer import forward as ref_forward

    rc, tc = _ep_config(False)
    rp = init_params(rc, jax.random.PRNGKey(0))
    tp = convert.params_tree(_np(rp), device="cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                         64)).astype(np.int64)
    x = np.random.default_rng(3).normal(size=(4, 16, 32)).astype(np.float32)
    torch.save(tp, tmp_path / "lm.pt")
    torch.save(ttf._layer(ttf._layer(tp["layers"], 0), 0),
               tmp_path / "layer.pt")
    np.save(tmp_path / "tokens.npy", toks)
    np.save(tmp_path / "x.npy", x)
    _, tfsdp = _ep_config(True)
    jobs = [{"kind": "moe", "work": str(tmp_path), "cfg": tc,
             "params": "lm", "out": "ep14", "shape": (1, 4)},
            {"kind": "moe", "work": str(tmp_path), "cfg": tfsdp,
             "params": "lm", "out": "ep22", "shape": (2, 2)},
            {"kind": "moe", "work": str(tmp_path), "cfg": tc,
             "params": "layer", "layer": True, "out": "layer14",
             "shape": (1, 4)}]
    spawn(mesh_jobs.run, (4,), ("data",), backend="gloo", device="cpu",
          args=(jobs,), timeout_s=TIMEOUT_S)
    one = ttf.forward(tp, torch.from_numpy(toks), tc).numpy()
    ref = np.asarray(ref_forward(rp, jnp.asarray(toks), rc))
    np.testing.assert_allclose(one, ref, rtol=1e-5, atol=1e-5)
    for name in ("ep14", "ep22"):
        got = np.load(tmp_path / f"{name}.npy")
        np.testing.assert_allclose(got, one, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    lp = ttf._layer(ttf._layer(tp["layers"], 0), 0)
    want = tmoe.moe_ffn(torch.from_numpy(x), lp, tc.moe, None).numpy()
    np.testing.assert_allclose(np.load(tmp_path / "layer14.npy"), want,
                               rtol=2e-3, atol=2e-3)


def test_moe_on_a_mesh_without_expert_split_is_refused():
    _, tc = _pair()
    mesh = type("M", (), {"axis_names": ("data", "model"), "world": 4,
                          "size": lambda self, a: {"data": 4,
                                                   "model": 1}[a]})()
    x = torch.zeros((1, 2, 16))
    lp = ttf.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="global batch"):
        tmoe.moe_ffn(x, ttf._layer(ttf._layer(lp["layers"], 0), 0), tc.moe,
                     mesh)
