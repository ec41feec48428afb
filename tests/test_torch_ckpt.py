"""The port's checkpoint store (``repro_torch.ckpt``) and training driver
(``repro_torch.launch.train``) against the reference's.

tests/test_ckpt.py's cases (roundtrip with a bfloat16 leaf, GC, a stale
``.tmp``, a shape mismatch) run on the port.  The files are the
reference's: a ``(mind_params, adamw_state)`` checkpoint written by either
package is restored bit-equal by the other, and both write the same
manifest and the same ``.npy`` bytes.  Resume is bit-exact: in process on
MIND (the LM is not ported yet), and through the CLI's ``--fail-at`` and
relaunch."""
import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import torch_threads  # noqa: E402,F401
from repro_torch import ckpt, convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.data.synthetic import recsys_batch  # noqa: E402
from repro_torch.distributed.collectives import tree_flatten  # noqa: E402
from repro_torch.models import recsys as trs  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 3), generator=g),
            "opt": [torch.arange(5, dtype=torch.int32),
                    {"m": torch.ones((2, 2), dtype=torch.bfloat16)}]}


def _bits(t) -> bytes:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _assert_same_tree(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert _bits(x) == _bits(y)


# --------------------------------------------------------------------------
# tests/test_ckpt.py on the port
# --------------------------------------------------------------------------
def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(t, 3, str(tmp_path), extra={"cursor": 7})
    t2, step, extra = ckpt.restore(_tree(1), str(tmp_path))
    assert step == 3 and extra["cursor"] == 7
    _assert_same_tree(t, t2)


def test_gc_keeps_last_k(tmp_path):
    t = _tree()
    for s in range(6):
        ckpt.save(t, s, str(tmp_path), keep=3)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 3 and dirs[-1] == "step_00000005"


def test_restore_ignores_stale_tmp(tmp_path):
    t = _tree()
    ckpt.save(t, 1, str(tmp_path))
    # a crashed writer leaves a .tmp dir and a half-written dir w/o manifest
    os.makedirs(tmp_path / "step_00000002.tmp")
    os.makedirs(tmp_path / "step_00000003")
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, step, _ = ckpt.restore(t, str(tmp_path))
    assert step == 1


def test_shape_mismatch_rejected(tmp_path):
    ckpt.save(_tree(), 1, str(tmp_path))
    bad = {"w": torch.zeros((5, 3)),
           "opt": [torch.arange(5, dtype=torch.int32),
                   {"m": torch.ones((2, 2), dtype=torch.bfloat16)}]}
    with pytest.raises(ValueError):
        ckpt.restore(bad, str(tmp_path))


def test_restore_takes_the_dtype_of_tree_like(tmp_path):
    """Each leaf comes back in its tree_like leaf's dtype, as the
    reference's ``jnp.asarray(arr, dtype=leaf.dtype)`` gives it."""
    ckpt.save({"a": torch.arange(4, dtype=torch.int32)}, 1, str(tmp_path))
    out, _, _ = ckpt.restore({"a": torch.zeros(4)}, str(tmp_path))
    assert out["a"].dtype == torch.float32
    np.testing.assert_array_equal(out["a"].numpy(), [0, 1, 2, 3])


# --------------------------------------------------------------------------
# the files are the reference's
# --------------------------------------------------------------------------
def _mind_state():
    """A reduced MIND's reference params and AdamW state after two steps
    (non-zero moments), as the reference's pytree and as the port's."""
    from repro.configs import get
    from repro.models.recsys import init_params, make_train_step
    from repro.optim import adamw

    rcfg = dataclasses.replace(get("mind").config, table_rows=2048)
    params = jax.jit(lambda k: init_params(rcfg, k))(jax.random.PRNGKey(0))
    opt = adamw.init(params)
    step = jax.jit(make_train_step(rcfg))
    b = recsys_batch(32, 1, 2048, seq_len=rcfg.seq_len, seed=1)
    b = {k: jnp.asarray(v) for k, v in b.items()}
    for _ in range(2):
        params, opt, _ = step(params, opt, b)
    as_np = lambda t: jax.tree.map(np.asarray, t)
    tparams = convert.params_tree(as_np(params), device="cpu")
    topt = convert.adamw_state(np.asarray(opt.step), as_np(opt.mu),
                               as_np(opt.nu), device="cpu")
    return (params, opt), (tparams, topt)


def _port_like():
    cfg = dataclasses.replace(tget("mind").config, table_rows=2048)
    p = trs.init_params(cfg, torch.Generator().manual_seed(5))
    return p, tadamw.init(p)


def test_reference_checkpoint_restored_bit_equal(tmp_path):
    from repro import ckpt as rckpt

    ref_tree, port_tree = _mind_state()
    rckpt.save(ref_tree, 2, str(tmp_path), extra={"cursor": 2})
    (params, opt), step, extra = ckpt.restore(_port_like(), str(tmp_path))
    assert step == 2 and extra == {"cursor": 2}
    assert isinstance(opt, tadamw.AdamWState)
    assert opt.step.dtype == torch.int32
    _assert_same_tree((params, opt), port_tree)


def test_port_checkpoint_restored_bit_equal_by_reference(tmp_path):
    from repro import ckpt as rckpt

    ref_tree, port_tree = _mind_state()
    ckpt.save(port_tree, 2, str(tmp_path), extra={"cursor": 2})
    like = jax.tree.map(jnp.zeros_like, ref_tree)
    got, step, extra = rckpt.restore(like, str(tmp_path))
    assert step == 2 and extra == {"cursor": 2}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_tree)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_files_byte_equal_between_packages(tmp_path):
    """The same tree written by both packages: the same file names (leaf
    order and path names, ``0_table``, ``1_step``, ``1_mu_table``...), the
    same manifest and the same ``.npy`` bytes; a bfloat16 leaf included."""
    from repro import ckpt as rckpt

    ref_tree, port_tree = _mind_state()
    bf = np.arange(6, dtype=np.float32).reshape(2, 3) / 3
    ref_tree = (*ref_tree, {"m": jnp.asarray(bf, jnp.bfloat16)})
    port_tree = (*port_tree, {"m": torch.from_numpy(bf).to(torch.bfloat16)})
    rckpt.save(ref_tree, 4, str(tmp_path / "ref"), extra={"cursor": 4})
    ckpt.save(port_tree, 4, str(tmp_path / "port"), extra={"cursor": 4})
    a, b = tmp_path / "ref" / "step_00000004", \
        tmp_path / "port" / "step_00000004"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names[:4] == ["0000_0_bilinear.npy", "0001_0_label_proj.npy",
                         "0002_0_table.npy", "0003_1_step.npy"]
    assert "0009_1_nu_table.npy" in names and "0010_2_m.npy" in names
    manifest = json.loads((b / "manifest.json").read_text())
    assert manifest["leaves"][-1]["dtype"] == "bfloat16"
    assert manifest["leaves"][-1]["raw_view"] is True
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


# --------------------------------------------------------------------------
# resume is bit-exact
# --------------------------------------------------------------------------
def test_train_resume_bit_exact(tmp_path):
    """tests/test_ckpt.py's resume on MIND: crash after step 5, restore
    from the step-5 checkpoint, continue; the final params and AdamW state
    equal an uninterrupted run's bit for bit."""
    cfg = dataclasses.replace(tget("mind").config, table_rows=2048)
    step_fn = trs.make_train_step(cfg)
    batch = {k: torch.from_numpy(v) for k, v in recsys_batch(
        16, 1, 2048, seq_len=cfg.seq_len, seed=3).items()}

    def run(n_steps, params, opt, start=0, save_at=None, root=None):
        for s in range(start, n_steps):
            params, opt, _ = step_fn(params, opt, batch)
            if save_at is not None and s + 1 == save_at:
                ckpt.save((params, opt), s + 1, root)
        return params, opt

    p0 = trs.init_params(cfg, torch.Generator().manual_seed(0))
    o0 = tadamw.init(p0)
    ref = run(10, p0, o0)
    root = str(tmp_path / "ck")
    run(5, p0, o0, save_at=5, root=root)
    (p2, o2), step, _ = ckpt.restore((p0, o0), root)
    assert step == 5
    _assert_same_tree(run(10, p2, o2, start=5), ref)


def test_cli_fail_at_and_resume_bit_exact(tmp_path, capsys):
    """``launch/train.py``: ``--fail-at 8`` raises; the relaunch resumes
    from step 5 and its final checkpoint's files are byte-equal to an
    uninterrupted run's."""
    from repro_torch.launch.train import main

    base = ["--arch", "mind", "--steps", "12", "--ckpt-every", "5",
            "--device", "cpu"]
    w1, w2 = str(tmp_path / "w1"), str(tmp_path / "w2")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        main(base + ["--fail-at", "8", "--workdir", w1])
    main(base + ["--workdir", w1])
    assert "resumed from step 5 (cursor=5)" in capsys.readouterr().out
    main(base + ["--workdir", w2])
    a = os.path.join(w1, "ckpt", "step_00000012")
    b = os.path.join(w2, "ckpt", "step_00000012")
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and "manifest.json" in names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == []


def test_cli_refuses_what_it_does_not_drive(tmp_path):
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit, match="launch/serve.py"):
        main(["--arch", "helmsman", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="LM family only"):
        main(["--arch", "din", "--accum", "2", "--device", "cpu",
              "--workdir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--arch", "mind", "--workdir", str(tmp_path)])
