"""The dry run's cells (``repro_torch.launch.cells``) against the
reference's (``repro.launch.cells``).

For every (arch, shape) of the 11 archs, both variants and both
production meshes: the model flops are equal, the abstract arguments have
equal global shapes and dtypes, and the in specs, out specs and donated
arguments are equal.  The reference's cells are built on a stand-in with
the production mesh's shape and axes (its builders read nothing else of
the mesh); the port's on ``dry_mesh`` (rank 0 of a fake process group).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from _torch_port import torch_threads  # noqa: E402,F401
from repro.configs import all_archs as r_all_archs  # noqa: E402
from repro.configs import get as rget  # noqa: E402
from repro.launch import cells as rcells  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION_SHAPES, dry_mesh  # noqa: E402

ARCHS = [a.name for a in r_all_archs()]


class _MeshShape:
    """What the reference's builders read of a mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    yield
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def _leaves(tree) -> list:
    """Leaves in the reference's flatten order (dict keys sorted); a spec,
    an array stand-in and None are leaves."""
    if tree is None or isinstance(tree, (JP, P)) or hasattr(tree, "shape"):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(type(tree))


def _spec(x):
    """A spec's entries; a one-axis tuple is that axis (the same sharding;
    the reference's ``PartitionSpec`` prints it so)."""
    if x is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in x)


def _sds(x):
    dt = x.dtype
    name = str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name
    return tuple(x.shape), name


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_match_the_reference(arch, mesh_kind):
    shape, axes = PRODUCTION_SHAPES[mesh_kind == "multi"]
    mesh = dry_mesh(mesh_kind == "multi")
    rmesh = _MeshShape(shape, axes)
    assert tcells.dp_size(mesh) == rcells.dp_size(rmesh)
    assert tcells.batch_axes(mesh) == rcells.batch_axes(rmesh)
    ra, ta = rget(arch), tget(arch)
    assert list(ra.shapes) == list(ta.shapes)
    for shape_name in ra.shapes:
        for variant in ("base", "opt"):
            what = (arch, shape_name, mesh_kind, variant)
            rc = rcells.build_cell(ra, shape_name, rmesh, variant=variant)
            tc = tcells.build_cell(ta, shape_name, mesh, variant=variant)
            assert tc.model_flops == rc.model_flops, what
            assert (tc.arch, tc.shape, tc.donate, tc.note) == (
                rc.arch, rc.shape, rc.donate, rc.note), what
            rargs, targs = _leaves(rc.abstract_args), _leaves(tc.abstract_args)
            assert [_sds(x) for x in targs] == [_sds(x) for x in rargs], what
            rin, tin = _leaves(rc.in_specs), _leaves(tc.in_specs)
            assert [_spec(x) for x in tin] == [_spec(x) for x in rin], what
            assert len(tin) == len(targs), what
            rout, tout = _leaves(rc.out_specs), _leaves(tc.out_specs)
            assert [_spec(x) for x in tout] == [_spec(x) for x in rout], what


def test_optimize_arch_matches_the_reference():
    assert tcells.OPT_OVERRIDES == rcells.OPT_OVERRIDES
    for arch in ARCHS:
        ra, ta = rget(arch), tget(arch)
        for shape_name in ra.shapes:
            r = rcells.optimize_arch(ra, shape_name).config
            t = tcells.optimize_arch(ta, shape_name).config
            for f in ("pad_heads_to", "seq_parallel", "pure_dp", "row_dp",
                      "sharded_mp"):
                assert getattr(t, f, None) == getattr(r, f, None), (
                    arch, shape_name, f)
