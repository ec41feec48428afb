"""The dry run (``repro_torch.launch.dryrun``, ``launch/op_analysis.py``).

* The op counter counts a rank's local work: a column-parallel then a
  row-parallel product on a fake (2, 4) mesh gives the local products'
  flops and one all-reduce of the local output.
* Full-width cells, one per family, run on both production meshes and
  write the reference's record keys.
* ``--all`` lists 80 cell runs and writes 6 skip records.
* Per-device counts against the reference: scaled cells on a (2, 4) mesh,
  the port's counted on rank 0 of a fake group, the reference's from its
  compiled HLO (``hlo_analysis.analyze``) with 8 forced host devices in a
  subprocess.  ``anns_build`` and a dense LM ``train`` cell agree within
  15% in flops; every scaled cell's ratio is printed (``pytest -s``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from _torch_port import torch_threads  # noqa: E402,F401
from repro_torch.configs import ArchDef, ShapeDef  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import dry_mesh  # noqa: E402
from repro_torch.launch.train import scaled_lm_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's per-cell record keys (repro/launch/dryrun.py run_cell),
# with hlo_chars replaced by n_local_ops
REF_KEYS = {"arch", "shape", "mesh", "variant", "ok", "n_chips", "flops",
            "bytes_accessed", "raw_cost_analysis", "n_while_loops",
            "collectives", "memory_analysis", "bytes_per_device",
            "roofline", "model_flops", "useful_ratio", "note", "seconds"}


@pytest.fixture(autouse=True)
def _fake_group():
    yield
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def test_op_counter_counts_the_local_work():
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import P, distribute, \
        implicit_replication
    from repro_torch.launch.op_analysis import OpCounter

    mesh = dry_mesh(shape=(2, 4), axes=("data", "model"))
    meta = lambda *s: torch.empty(s, device="meta")
    x, w1, w2 = distribute((meta(64, 32), meta(32, 16), meta(16, 8)),
                           (P("data", None), P(None, "model"),
                            P("model", None)), mesh)
    counter = OpCounter((x, w1, w2))
    with counter, implicit_replication():
        y = (x @ w1) @ w2                   # (32, 4) then a partial (32, 8)
        y = y.redistribute(mesh.device_mesh, [Replicate(), Replicate()])
    tot = counter.totals
    assert tot.flops == 2 * 32 * 32 * 4 + 2 * 32 * 4 * 8
    assert tot.global_flops == 2 * 64 * 32 * 16 + 2 * 64 * 16 * 8
    assert tot.coll_ops["all-reduce"] == 1
    assert tot.coll["all-reduce"] == 2.0 * 32 * 8 * 4       # ring factor 2
    assert tot.arg_bytes == 4 * (32 * 32 + 32 * 4 + 4 * 8)
    assert tot.peak_bytes >= tot.arg_bytes + 4 * (32 * 4 + 32 * 8)


@pytest.mark.parametrize("arch,shape", [
    ("helmsman", "serve_online"), ("mind", "train_batch"),
    ("graphcast", "molecule"), ("qwen2_moe", "decode_32k")])
def test_full_width_cells_run_on_both_meshes(tmp_path, arch, shape):
    for mesh in ("single", "multi"):
        rec = dryrun.run_cell(arch, shape, mesh, str(tmp_path))
        assert rec["ok"], rec.get("traceback")
        assert REF_KEYS <= set(rec) and "n_local_ops" in rec
        assert rec["n_chips"] == (256 if mesh == "single" else 512)
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert isinstance(rec["fits"], bool)
        with open(tmp_path / f"{arch}.{shape}.{mesh}.json") as f:
            assert json.load(f)["ok"]


def test_the_sweep_lists_80_runs_and_6_skips(tmp_path):
    cells = dryrun.cell_list(mesh="both", all_=True, out_dir=str(tmp_path))
    assert len(cells) == 80 and len(set(cells)) == 80
    skips = sorted(os.listdir(tmp_path))
    assert len(skips) == 6
    for name in skips:
        with open(tmp_path / name) as f:
            rec = json.load(f)
        assert rec["ok"] is None and rec["shape"] == "long_500k"
        assert "sub-quadratic" in rec["skipped"]


# --------------------------------------------------------------------------
# per-device counts against the reference's compiled HLO
# --------------------------------------------------------------------------
# name -> (family, arch, config overrides, (shape name, kind, batch, seq,
# extras)); the same recipe builds both packages' cells
SCALED = {
    "anns_build": ("anns", "helmsman", {"dim": 32},
                   ("build_step", "anns_build", 8192, 0,
                    (("k_coarse", 64),))),
    "anns_serve": ("anns", "helmsman", {"n_clusters": 512, "cluster_len": 16,
                                        "dim": 32, "nprobe_max": 16, "k": 10},
                   ("serve_online", "anns_serve", 64, 0, ())),
    "lm_train_heads": ("lm", "phi4_mini", {"n_heads": 4, "n_kv": 4},
                       ("train_4k", "train", 8, 64, ())),
    "lm_train_dh": ("lm", "phi4_mini", {}, ("train_4k", "train", 8, 64, ())),
    "lm_prefill": ("lm", "phi4_mini", {"n_heads": 4, "n_kv": 4},
                   ("prefill_32k", "prefill", 8, 64, ())),
    "lm_decode": ("lm", "phi4_mini", {"n_heads": 4, "n_kv": 4},
                  ("decode_32k", "decode", 8, 64, ())),
    "moe_train": ("lm", "qwen2_moe", {}, ("train_4k", "train", 8, 64, ())),
    "recsys_train": ("recsys", "mind", {"table_rows": 4096},
                     ("train_batch", "train", 512, 0, ())),
    "gnn_train": ("gnn", "graphcast", {"n_layers": 2, "d_hidden": 32,
                                       "n_vars": 8},
                  ("full_graph_sm", "train", 1, 0,
                   (("n_nodes", 256), ("n_edges", 1024), ("d_feat", 16),
                    ("mode", "full")))),
}
WITHIN_15 = ("anns_build", "lm_train_heads")

_REF = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ArchDef, ShapeDef, get
    from repro.launch.cells import build_cell
    from repro.launch.hlo_analysis import analyze
    from repro.launch.train import scaled_lm_config

    cases = json.loads(sys.argv[1])
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4),
                             ("data", "model"))
    out = {}
    for name, (family, arch, kw, (sname, kind, b, s, extras)) in cases.items():
        cfg = get(arch).config
        if family == "lm":
            cfg = scaled_lm_config(cfg, 0.02)
        cfg = dataclasses.replace(cfg, **kw)
        extras = tuple(tuple(x) for x in extras)
        ad = ArchDef(arch, family, cfg, {sname: ShapeDef(sname, kind, b, s,
                                                         extras)})
        cell = build_cell(ad, sname, mesh)
        sh = lambda spec, ab: jax.tree.map(
            lambda sp, _: NamedSharding(mesh, sp), spec, ab,
            is_leaf=lambda x: isinstance(x, P))
        in_sh = tuple(sh(sp, ab) for sp, ab in zip(cell.in_specs,
                                                   cell.abstract_args))
        out_sh = None if cell.out_specs is None else jax.tree.map(
            lambda sp: NamedSharding(mesh, sp), cell.out_specs,
            is_leaf=lambda x: isinstance(x, P))
        with mesh:
            compiled = jax.jit(cell.fn, in_shardings=in_sh,
                               out_shardings=out_sh).lower(
                *cell.abstract_args).compile()
        t = analyze(compiled.as_text())
        out[name] = {"flops": t.flops, "coll": t.coll_total}
    print("REF " + json.dumps(out))
""")


def _scaled_arch(name):
    family, arch, kw, (sname, kind, b, s, extras) = SCALED[name]
    cfg = tget(arch).config
    if family == "lm":
        cfg = scaled_lm_config(cfg, 0.02)
    cfg = dataclasses.replace(cfg, **kw)
    return ArchDef(arch, family, cfg, {sname: ShapeDef(sname, kind, b, s,
                                                       extras)}), sname


def test_per_device_flops_match_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _REF, json.dumps(SCALED)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        mesh = dry_mesh(shape=(2, 4), axes=("data", "model"))
        port = {}
        for name in SCALED:
            arch, sname = _scaled_arch(name)
            _, tot, _, _ = dryrun.measure_cell(arch, sname, mesh)
            port[name] = {"flops": tot.flops, "coll": tot.coll_total}
        text, _ = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    line = [x for x in text.splitlines() if x.startswith("REF ")]
    assert line, text[-4000:]
    want = json.loads(line[0][4:])
    print("\ncell               port flops    ref flops    ratio   port coll"
          "    ref coll")
    for name in SCALED:
        p, r = port[name], want[name]
        print(f"{name:16s} {p['flops']:12.4g} {r['flops']:12.4g} "
              f"{p['flops'] / r['flops']:8.4f} {p['coll']:11.4g} "
              f"{r['coll']:11.4g}")
    for name in WITHIN_15:
        ratio = port[name]["flops"] / want[name]["flops"]
        assert 0.85 <= ratio <= 1.15, (name, ratio)
