"""``repro_torch.launch.train``'s LM and GNN branches on the CPU, against
the reference's where it runs.

* ``--fail-at`` then a relaunch on qwen2-moe (the MoE combine and
  gathers repeat bit for bit): the relaunch resumes from the last
  checkpoint and its final checkpoint is byte-equal to an uninterrupted
  run's, as tests/test_ckpt.py's ``test_train_resume_bit_exact`` asks of
  the reference.
* ``--accum 2`` on phi4-mini prints finite losses; its step is the
  reference's accumulation (the mean of the microbatch gradients, one
  AdamW update), held here against the reference's gradients and AdamW;
  the reference's own ``--accum`` path raises ``KeyError: 'loss'`` (its
  metrics carry none), which the port reports as the mean microbatch loss
  (ROADMAP section 3, an intended divergence).
* The GNN branch trains GraphCast at 4 x 64 on the constant graph.
* An LM checkpoint (bf16 params and AdamW state) has the reference's file
  names, manifest and bytes.
"""
import filecmp
import json
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import STEP_PARAM_ATOL, torch_threads  # noqa: E402,F401
from repro_torch import ckpt, convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.distributed.collectives import tree_flatten  # noqa: E402
from repro_torch.launch.train import main, make_accum_step, \
    scaled_lm_config  # noqa: E402

LOSS = re.compile(r"loss=([-\w.]+)")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_lm_fail_and_relaunch_is_byte_equal(tmp_path, capsys):
    base = ["--arch", "qwen2_moe", "--steps", "6", "--ckpt-every", "2",
            "--scale", "0.02", "--device", "cpu"]
    wa, wb = str(tmp_path / "a"), str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="simulated node failure at "
                                           "step 3"):
        main(base + ["--fail-at", "3", "--workdir", wa])
    main(base + ["--workdir", wa])
    assert "resumed from step 2 (cursor=2)" in capsys.readouterr().out
    main(base + ["--workdir", wb])
    a = os.path.join(wa, "ckpt", "step_00000006")
    b = os.path.join(wb, "ckpt", "step_00000006")
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and "manifest.json" in names
    assert any("moe_gate" in n for n in names)
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == []


def test_accum_matches_the_reference_and_reports_a_loss(tmp_path, capsys,
                                                        monkeypatch):
    from repro.configs import get as rget
    from repro.launch import train as rtrain
    from repro.models.lm import init_params
    from repro.models.lm import transformer as rtf
    from repro.optim import adamw as radamw
    from repro_torch.optim import adamw as tadamw

    main(["--arch", "phi4_mini", "--steps", "3", "--accum", "2", "--scale",
          "0.02", "--device", "cpu", "--workdir", str(tmp_path / "port")])
    losses = [float(v) for v in LOSS.findall(capsys.readouterr().out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    # one accumulated step against the reference's arithmetic
    rc = rtrain.scaled_lm_config(rget("phi4_mini").config, 0.02)
    tc = scaled_lm_config(tget("phi4_mini").config, 0.02)
    rp = init_params(rc, jax.random.PRNGKey(0))
    micro = np.random.default_rng(3).integers(
        0, rc.vocab, size=(2, 2, 17)).astype(np.int32)
    grads = [jax.grad(lambda p: rtf.loss_fn(p, jnp.asarray(m), rc))(rp)
             for m in micro]
    g = jax.tree.map(lambda a, b: (a + b) / 2, grads[0], grads[1])
    want, _, _ = radamw.apply(rp, g, radamw.init(rp), radamw.AdamWConfig())
    tp = convert.params_tree(_np(rp), device="cpu")
    got, _, m = make_accum_step(tc)(tp, tadamw.init(tp),
                                    torch.from_numpy(micro))
    for x, y in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=STEP_PARAM_ATOL)
    ref_losses = [float(rtf.loss_fn(rp, jnp.asarray(x), rc)) for x in micro]
    np.testing.assert_allclose(float(m["loss"]), np.mean(ref_losses),
                               rtol=1e-5)
    # the reference's --accum path: its metrics have no "loss"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "phi4_mini", "--steps", "1", "--accum", "2",
        "--scale", "0.02", "--workdir", str(tmp_path / "ref")])
    with pytest.raises(KeyError, match="loss"):
        rtrain.main()


def test_gnn_branch_trains(tmp_path, capsys):
    main(["--arch", "graphcast", "--steps", "6", "--ckpt-every", "3",
          "--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(v) for v in LOSS.findall(out)]
    assert "arch=graphcast" in out and out.strip().endswith("done")
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 6
    with pytest.raises(NotImplementedError, match="LM family only"):
        main(["--arch", "graphcast", "--accum", "2", "--device", "cpu",
              "--workdir", str(tmp_path / "x")])


def test_lm_checkpoint_equals_the_reference(tmp_path):
    """bf16 params and an AdamW state (float32 moments after a step) of
    phi4-mini's scaled config: the same file names, manifest (bfloat16
    leaves as raw uint16 views) and bytes from both packages."""
    import dataclasses

    from repro import ckpt as rckpt
    from repro.configs import get as rget
    from repro.launch.train import scaled_lm_config as r_scaled
    from repro.models.lm import init_params
    from repro.models.lm import transformer as rtf
    from repro.optim import adamw as radamw

    rc = dataclasses.replace(r_scaled(rget("phi4_mini").config, 0.02),
                             dtype=jnp.bfloat16)
    rp = init_params(rc, jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(1).integers(
        0, rc.vocab, size=(2, 9)).astype(np.int32))
    rp, ropt, _ = rtf.make_train_step(rc)(rp, radamw.init(rp), toks)
    rckpt.save((rp, ropt), 4, str(tmp_path / "ref"), extra={"cursor": 4})
    tp = convert.params_tree(_np(rp), device="cpu")
    topt = convert.adamw_state(np.asarray(ropt.step), _np(ropt.mu),
                               _np(ropt.nu), device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert topt.mu["embed"].dtype == torch.float32
    ckpt.save((tp, topt), 4, str(tmp_path / "port"), extra={"cursor": 4})
    a = tmp_path / "ref" / "step_00000004"
    b = tmp_path / "port" / "step_00000004"
    names = sorted(os.listdir(a))
    assert sorted(os.listdir(b)) == names
    assert json.loads((a / "manifest.json").read_text()) == \
        json.loads((b / "manifest.json").read_text())
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == []
    back, step, extra = ckpt.restore((tp, topt), str(tmp_path / "ref"))
    assert step == 4 and extra["cursor"] == 4
    for x, y in zip(tree_flatten(back)[0], tree_flatten((tp, topt))[0]):
        assert torch.equal(x, y)
