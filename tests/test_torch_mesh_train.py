"""The mesh train steps (``make_train_step(mesh=...)`` of the recsys, LM
and GNN families) against the port's one-process step and against the
reference's mesh step.

Each case is a cell of ``launch/cells.py`` at a reduced size: MIND; a
scaled qwen2-moe at capacity factor 4 (its tokens chosen so that no
expert overflows on either mesh: past capacity, one process and a mesh
keep different tokens, ROADMAP §3); scaled phi4-mini configs whose heads
hit every regime of ``param_specs`` at TP 2 and 4 (heads with the KV
heads replicated or split, Dh, replicated); GraphCast with ``sharded_mp``
and with ``row_dp``.  One ``spawn`` of four gloo ranks runs every case on
the (2, 2) and the (1, 4) mesh (``mesh_jobs`` ``cell``: the global
arguments placed as DTensors by the cell's specs); one subprocess with 4
forced host devices runs the reference's cells jitted with their
shardings on (2, 2), from the same arrays.

After one step the loss agrees within rtol 1e-5, the moments within 1e-5
of the largest, and every parameter within ``STEP_PARAM_ATOL`` beyond
``adamw_step_gap`` (the part of the difference that AdamW's own update
makes of two gradients' difference where |g| is near eps).  The LM
parameters carry the attention rescale of ``tests/test_torch_lm.py``
(``contracted``): under the reference's init two float32 evaluations of a
scaled LM drift apart.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_port import STEP_PARAM_ATOL, adamw_step_gap, \
    torch_threads  # noqa: E402,F401
from repro_torch.configs import ArchDef, ShapeDef  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.distributed.collectives import tree_flatten, \
    tree_flatten_with_path  # noqa: E402
from repro_torch.launch import mesh_jobs  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.train import scaled_lm_config  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

MESHES = [(2, 2), (1, 4)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (family, arch, config overrides, shape); the same recipe builds
# the port's and the reference's config
CASES = {
    "mind": ("recsys", "mind", {"table_rows": 256},
             ("train_batch", "train", 64, 0, ())),
    "qwen2_moe_cf4": ("lm", "qwen2_moe", {}, ("train_4k", "train", 16, 16,
                                              ())),
    "phi4_h2": ("lm", "phi4_mini", {}, ("train_4k", "train", 4, 16, ())),
    "phi4_h4_kv4": ("lm", "phi4_mini", {"n_heads": 4, "n_kv": 4},
                    ("train_4k", "train", 4, 16, ())),
    "phi4_h3": ("lm", "phi4_mini", {"n_heads": 3, "d_head": 6},
                ("train_4k", "train", 4, 16, ())),
    "graphcast_sharded_mp": (
        "gnn", "graphcast", {"n_layers": 2, "d_hidden": 16, "n_vars": 3,
                             "sharded_mp": True},
        ("g", "train", 1, 0, (("n_nodes", 40), ("n_edges", 128),
                              ("d_feat", 8), ("mode", "full")))),
    "graphcast_row_dp": (
        "gnn", "graphcast", {"n_layers": 2, "d_hidden": 16, "n_vars": 3,
                             "row_dp": True},
        ("g", "train", 1, 0, (("n_nodes", 40), ("n_edges", 128),
                              ("d_feat", 8), ("mode", "full")))),
}
SEEDS = {"qwen2_moe_cf4": 1}     # tokens with no expert over capacity


def _config(family, arch, kw, get, scaled):
    cfg = get(arch).config
    if family == "lm":
        cfg = scaled(cfg, 0.02)
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    return dataclasses.replace(cfg, **kw)


def _arch(name):
    family, arch, kw, (sname, kind, b, s, extras) = CASES[name]
    cfg = _config(family, arch, kw, tget, scaled_lm_config)
    return ArchDef(arch, family, cfg, {sname: ShapeDef(sname, kind, b, s,
                                                       extras)}), sname


def _contracted(params, cfg):
    """The attention projections rescaled to the contracted dims."""
    h, kv, d = cfg.heads_padded, cfg.n_kv, cfg.d_model
    for group in ("layers", "tail"):
        g = params.get(group)
        if g is not None:
            g["wq"].mul_(math.sqrt(h / d))
            g["wk"].mul_(math.sqrt(kv / d))
            g["wv"].mul_(math.sqrt(kv / d))
            g["wo"].mul_(math.sqrt(1.0 / h))
    return params


def _inputs(name):
    """The cell's global arguments (params, AdamW state, batch)."""
    arch, sname = _arch(name)
    cfg, shape = arch.config, arch.shapes[sname]
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(SEEDS.get(name, 0))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if arch.family == "recsys":
        from repro_torch.models.recsys import models as rm

        params = rm.init_params(cfg, g, "cpu")
        b, rows = shape.batch, cfg.table_rows
        batch = {"sparse_ids": t(rng.integers(0, rows, (b, cfg.n_sparse))
                                 .astype(np.int32)),
                 "labels": t(rng.integers(0, 2, b).astype(np.float32)),
                 "hist_ids": t(rng.integers(-1, rows, (b, cfg.seq_len))
                               .astype(np.int32)),
                 "hist_len": t(rng.integers(1, cfg.seq_len + 1, b)
                               .astype(np.int32))}
    elif arch.family == "lm":
        from repro_torch.models.lm import transformer as tf

        params = _contracted(tf.init_params(cfg, g, "cpu"), cfg)
        batch = t(rng.integers(0, cfg.vocab, (shape.batch, shape.seq + 1))
                  .astype(np.int32))
    else:
        from repro_torch.models.gnn import graphcast as gc

        n, e, d = (shape.get(k) for k in ("n_nodes", "n_edges", "d_feat"))
        params = gc.init_params(cfg, d, g, "cpu")
        # dst-sorted edges, a quarter of them into each quarter of the
        # rows (row_dp's contract on four ranks; any graph for the rest)
        rows, per = n // 4, e // 4
        dst = np.concatenate([rng.integers(r * rows, (r + 1) * rows, per)
                              for r in range(4)]).astype(np.int32)
        batch = {"node_feats": t(rng.normal(size=(n, d)).astype(np.float32)),
                 "src": t(rng.integers(0, n, e).astype(np.int32)),
                 "dst": t(dst),
                 "edge_mask": t(rng.random(e) > 0.1),
                 "targets": t(rng.normal(size=(n, cfg.n_vars))
                              .astype(np.float32)),
                 "node_mask": t(rng.random(n) > 0.2)}
    return params, adamw.init(params), batch


def _one_process(name, args):
    arch, _ = _arch(name)
    cfg = dataclasses.replace(arch.config, **(
        {"row_dp": False, "sharded_mp": False}
        if arch.family == "gnn" else {}))
    if arch.family == "recsys":
        from repro_torch.models.recsys.models import make_train_step
    elif arch.family == "lm":
        from repro_torch.models.lm.transformer import make_train_step
    else:
        from repro_torch.models.gnn.graphcast import make_train_step
    return make_train_step(cfg)(*args)


_REF = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    assert len(jax.devices()) == 4
    from repro.configs import ArchDef, ShapeDef, get
    from repro.launch.cells import build_cell
    from repro.launch.train import scaled_lm_config
    from repro.optim import adamw

    work, cases = sys.argv[1], json.loads(sys.argv[2])
    # GSPMD's automatic axes, as the reference's dry run lowers its cells
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                             ("data", "model"))

    def config(family, arch, kw):
        cfg = get(arch).config
        if family == "lm":
            cfg = scaled_lm_config(cfg, 0.02)
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=4.0))
        return dataclasses.replace(cfg, **kw)

    def tree(flat):
        out = {}
        for path, a in flat.items():
            *head, last = path.split("/")
            d = out
            for k in head:
                d = d.setdefault(k, {})
            d[last] = jnp.asarray(a)
        return out

    for name, (family, arch, kw, (sname, kind, b, s, extras)) in cases.items():
        cfg = config(family, arch, kw)
        extras = tuple(tuple(x) for x in extras)
        ad = ArchDef(arch, family, cfg, {sname: ShapeDef(sname, kind, b, s,
                                                         extras)})
        cell = build_cell(ad, sname, mesh)
        with np.load(os.path.join(work, name + "_params.npz")) as z:
            params = tree(dict(z))
        with np.load(os.path.join(work, name + "_batch.npz")) as z:
            batch = {k: jnp.asarray(z[k]) for k in z.files}
        if family == "lm":
            batch = batch["tokens"]
        args = (params, adamw.init(params), batch)
        sh = lambda spec, ab: jax.tree.map(
            lambda sp, _: NamedSharding(mesh, sp), spec, ab,
            is_leaf=lambda x: isinstance(x, P))
        in_sh = tuple(sh(sp, ab) for sp, ab in zip(cell.in_specs, args))
        out_sh = jax.tree.map(lambda sp: NamedSharding(mesh, sp),
                              cell.out_specs,
                              is_leaf=lambda x: isinstance(x, P))
        with mesh:
            out = jax.jit(cell.fn, in_shardings=in_sh,
                          out_shardings=out_sh)(*args)
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(out)]
        np.savez(os.path.join(work, name + "_ref.npz"), *leaves)
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("mesh_train"))
    inputs, one = {}, {}
    jobs = []
    for name in CASES:
        args = _inputs(name)
        inputs[name] = args
        torch.save(args, os.path.join(work, f"{name}.pt"))
        params, _, batch = args
        np.savez(os.path.join(work, f"{name}_params.npz"), **{
            "/".join(p): x.numpy() for p, x in tree_flatten_with_path(params)})
        bt = batch if isinstance(batch, dict) else {"tokens": batch}
        np.savez(os.path.join(work, f"{name}_batch.npz"),
                 **{k: v.numpy() for k, v in bt.items()})
        arch, sname = _arch(name)
        for shape in MESHES:
            jobs.append({"kind": "cell", "shape": shape, "arch": arch,
                         "cell": sname, "work": work, "args": name,
                         "out": f"{name}_{shape[0]}x{shape[1]}"})
        one[name] = _one_process(name, args)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, work, json.dumps(CASES)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        spawn(mesh_jobs.run, (4,), ("data",), backend="gloo", device="cpu",
              args=(jobs,), timeout_s=600)
        ref_out, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert "REF_OK" in ref_out, ref_out[-4000:]
    mesh_out = {}
    for name in CASES:
        for shape in MESHES:
            mesh_out[name, shape] = torch.load(
                os.path.join(work, f"{name}_{shape[0]}x{shape[1]}.pt"),
                weights_only=False)
    ref = {}
    for name in CASES:
        with np.load(os.path.join(work, f"{name}_ref.npz")) as z:
            ref[name] = [z[f"arr_{i}"] for i in range(len(z.files))]
    return one, mesh_out, ref


def _compare(got, want, what):
    """One step's (params, AdamW state, metrics) against another's."""
    gp, gs, gm = got
    wp, ws, wm = want
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= \
        1e-5 * abs(float(wm["loss"])), (what, gm["loss"], wm["loss"])
    f = lambda tr: [np.asarray(x.detach().float()) for x in tree_flatten(tr)[0]]
    for name_, (a, b) in zip(("mu", "nu"), ((gs.mu, ws.mu), (gs.nu, ws.nu))):
        for x, y in zip(f(a), f(b)):
            assert np.abs(x - y).max(initial=0) <= \
                1e-5 * np.abs(y).max(initial=1e-30), (what, name_)
    for p, q, gm_, gv, wm_, wv in zip(f(gp), f(wp), f(gs.mu), f(gs.nu),
                                      f(ws.mu), f(ws.nu)):
        excess = np.abs(p - q) - adamw_step_gap(gm_, gv, wm_, wv)
        assert excess.max(initial=0) <= STEP_PARAM_ATOL, (what, excess.max())


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_one_process(runs, name, shape):
    one, mesh_out, _ = runs
    _compare(mesh_out[name, shape], one[name], (name, shape))


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_the_references_mesh_step(runs, name):
    _, mesh_out, ref = runs
    got = mesh_out[name, (2, 2)]
    leaves = [np.asarray(x.detach().float()) if torch.is_tensor(x)
              else np.asarray(x) for x in tree_flatten(got)[0]]
    want = ref[name]
    assert len(leaves) == len(want), name
    params, state, metrics = got
    n_p = len(tree_flatten(params)[0])
    wp = want[:n_p]
    wmu, wnu = want[n_p + 1:2 * n_p + 1], want[2 * n_p + 1:3 * n_p + 1]
    wmet = dict(zip(sorted(metrics), want[3 * n_p + 1:]))
    rebuilt = (
        [torch.from_numpy(np.asarray(x, np.float32)) for x in wp],
        adamw.AdamWState(step=torch.tensor(int(want[n_p])),
                         mu=[torch.from_numpy(np.asarray(x)) for x in wmu],
                         nu=[torch.from_numpy(np.asarray(x)) for x in wnu]),
        {k: torch.tensor(float(v)) for k, v in wmet.items()})
    flat = (tree_flatten(params)[0],
            adamw.AdamWState(step=state.step, mu=tree_flatten(state.mu)[0],
                             nu=tree_flatten(state.nu)[0]), metrics)
    _compare(flat, rebuilt, (name, "reference"))
    assert int(state.step) == int(want[n_p]) == 1


def test_mesh_steps_refuse_plain_tensors():
    """A mesh step takes the global arrays as DTensors."""
    arch, sname = _arch("phi4_h2")
    from repro_torch.launch.mesh import dry_mesh

    try:
        mesh = dry_mesh(shape=(2, 2), axes=("data", "model"))
        cell = build_cell(arch, sname, mesh)
        params, opt, tokens = _inputs("phi4_h2")
        with pytest.raises(TypeError, match="DTensor"):
            cell.fn(params, opt, tokens)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
