"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
``repro.optim.adamw`` on the same numpy params, gradients and state: the
new params, moments, step, gradient norm and learning rate within rtol
1e-6 (atol 1e-9 where a value sits near zero), at step 1 and at step
1,000, with the clip on and off, weight decay 0.1 and an ``lr_scale``;
``cosine_schedule`` equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import torch_threads  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.distributed.collectives import tree_flatten  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

RTOL, ATOL = 1e-6, 1e-9


def _tree(rng, scale=1.0, positive=False):
    draw = lambda *s: (np.abs if positive else np.asarray)(
        rng.normal(size=s) * scale).astype(np.float32)
    return {"w": draw(16, 8), "blk": {"b": draw(8), "k": draw(3, 4, 5)},
            "emb": draw(64, 4)}


@pytest.mark.parametrize("step0", [0, 999], ids=["step1", "step1000"])
@pytest.mark.parametrize("clip_norm", [1e9, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("lr_scale", [1.0, 0.37], ids=["lr1", "lr037"])
def test_apply_matches_reference(step0, clip_norm, lr_scale):
    from repro.optim import adamw

    rng = np.random.default_rng(step0 + int(clip_norm) % 7)
    params, grads = _tree(rng), _tree(rng, 0.3)
    mu, nu = _tree(rng, 0.01), _tree(rng, 1e-4, positive=True)
    cfg_kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=clip_norm)
    jstate = adamw.AdamWState(jnp.asarray(step0, jnp.int32),
                              jax.tree.map(jnp.asarray, mu),
                              jax.tree.map(jnp.asarray, nu))
    jp, js, jm = adamw.apply(jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, grads), jstate,
                             adamw.AdamWConfig(**cfg_kw), lr_scale)
    tstate = convert.adamw_state(np.int32(step0), mu, nu, device="cpu")
    tp, ts, tm = tadamw.apply(convert.params_tree(params, device="cpu"),
                              convert.params_tree(grads, device="cpu"),
                              tstate, tadamw.AdamWConfig(**cfg_kw), lr_scale)
    if clip_norm < 1:
        assert float(tm["grad_norm"]) > clip_norm      # the clip is live
    assert ts.step.dtype == torch.int32 and int(ts.step) == step0 + 1
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        g, w = tree_flatten(got)[0], jax.tree_util.tree_leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=RTOL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=RTOL)


def test_init_and_global_norm_match_reference():
    from repro.optim import adamw

    rng = np.random.default_rng(2)
    params = _tree(rng)
    st = tadamw.init(convert.params_tree(params, device="cpu"))
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    assert all(float(t.abs().sum()) == 0 for t in tree_flatten(st.mu)[0])
    np.testing.assert_allclose(
        float(tadamw.global_norm(convert.params_tree(params, device="cpu"))),
        float(adamw.global_norm(jax.tree.map(jnp.asarray, params))),
        rtol=RTOL)


def test_cosine_schedule_matches_reference():
    from repro.optim import adamw

    for warmup, total in ((10, 100), (0, 50), (5, 5)):
        f = tadamw.cosine_schedule(1e-3, warmup, total)
        g = adamw.cosine_schedule(1e-3, warmup, total)
        steps = np.arange(0, total + 6, dtype=np.int32)
        got = np.array([float(f(torch.tensor(s))) for s in steps])
        want = np.array([float(g(jnp.asarray(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
