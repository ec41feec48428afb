"""Sharding rules per architecture family (port of
``repro.distributed.sharding``).

Mesh axes (``launch/mesh.py``): single pod ``(data=16, model=16)``;
multi-pod ``(pod=2, data=16, model=16)``.  ``pod`` composes with ``data``
as an outer batch axis.
* LM: batch over (pod, data); Megatron TP over ``model`` (attention heads
  and d_ff columns, row-parallel second products, vocab on the
  embedding); MoE experts over ``model`` (EP).  Decode: batch over (pod,
  data); KV heads over ``model`` when divisible, else the sequence.
* GNN: edges over (pod, data), the hidden dim over ``model``.
* Recsys: embedding tables row-sharded over ``model``.
* ANNS: queries over (pod, data); posting clusters over ``model``;
  centroids and LLSP replicated.

A :class:`P` names, for each leading dimension of an array, the mesh axes
it is split over: ``None`` (whole), one axis name, or a tuple of names
(split row-major over those axes, the first outermost), as
``jax.sharding.PartitionSpec`` does.  Where ``shard_map`` cut each rank's
block by its ``in_specs`` and joined the outputs by its ``out_specs``,
:func:`shard_local` cuts this rank's block of a global array and
:func:`gather_axes` rebuilds a batch-sharded output on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


class P(tuple):
    """A partition spec: one entry per leading dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def data_spec(mesh, *trailing) -> P:
    """Batch-sharded leading dim, e.g. queries (B, D) -> P(('data',), None)."""
    return P(batch_axes(mesh), *trailing)


def replicated() -> P:
    return P()


def anns_specs(mesh) -> dict:
    return {
        "centroids": P(),
        "postings": P("model", None, None),
        "posting_ids": P("model", None),
        "llsp": P(),
        "queries": data_spec(mesh, None),
        "topk": data_spec(mesh),
    }


def recsys_table_spec() -> P:
    return P("model", None)          # rows over model: the EmbeddingBag path


def lm_param_specs(params_tree, mesh=None):
    """Megatron-style TP rules applied by leaf path name (the reference's
    rules, in its order):

    * MoE expert leaves (a ``moe`` path, rank >= 3) -> experts over model
    * ``wq/wk/wv`` -> P(None, "model", None); ``wo`` -> P("model", ...)
    * ``w_gate/w_up`` -> P(None, "model"); ``w_down`` -> P("model", None)
    * ``embed`` -> P("model", None); the router, norms and the rest
      replicated."""
    from .collectives import tree_flatten, tree_flatten_with_path, \
        tree_unflatten

    def spec_for(path: str, x) -> P:
        nd = x.dim()
        if "moe" in path and nd >= 3:
            return P("model", *([None] * (nd - 1)))          # EP
        if any(k in path for k in ("wq", "wk", "wv")):
            return P(None, "model", None)
        if "wo" in path:
            return P("model", None, None)
        if any(k in path for k in ("w_gate", "w_up")):
            return P(None, "model")
        if "w_down" in path:
            return P("model", None)
        if "embed" in path:
            return P("model", None)
        return P()

    specs = [spec_for("/".join(str(k) for k in path).lower(), leaf)
             for path, leaf in tree_flatten_with_path(params_tree)]
    return tree_unflatten(tree_flatten(params_tree)[1], specs)


def lm_kv_cache_spec(mesh, kv_heads: int, *, seq_split: bool = False) -> P:
    """KV cache (B, S, Hkv, Dh): heads over model if divisible, else the
    sequence split (the split-KV decode path)."""
    tp = mesh.shape["model"]
    if not seq_split and kv_heads % tp == 0:
        return P(batch_axes(mesh), None, "model", None)
    return P(batch_axes(mesh), "model", None, None)


def gnn_specs(mesh) -> dict:
    return {
        "edges": data_spec(mesh, None),
        "node_feats": P(None, "model"),
        "hidden": P(None, "model"),
    }


def axes_of(entry) -> tuple:
    """The mesh axes of a spec entry (None, one name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_of(axes: tuple):
    """The spec entry that splits a dim over ``axes``: None, one name, or
    the tuple."""
    return None if not axes else (axes[0] if len(axes) == 1
                                  else tuple(axes))


def _block_of(entry, mesh) -> tuple[int, int]:
    """(this rank's block index, number of blocks) of a dimension whose
    spec entry is ``entry``."""
    idx, n = 0, 1
    for axis in axes_of(entry):
        idx = idx * mesh.size(axis) + mesh.index(axis)
        n *= mesh.size(axis)
    return idx, n


def shard_local(array, spec: P, mesh):
    """This rank's block of the global ``array`` (a numpy array or a
    tensor; a view where slicing gives one) under ``spec``."""
    index = []
    for dim, entry in enumerate(spec):
        idx, n = _block_of(entry, mesh)
        size = array.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split over "
                             f"{axes_of(entry)} ({n} blocks)")
        step = size // n
        index.append(slice(idx * step, (idx + 1) * step))
    return array[tuple(index)]


def gather_axes(local: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The global tensor of which each rank holds the dim-0 block under
    ``P(axes)``: gathered over the innermost axis first, each in axis
    order (a reduce-scatter in the backward)."""
    from .collectives import all_gather_cat

    out = local
    for axis in reversed(axes_of(axes)):
        out = all_gather_cat(out, mesh.group(axis), dim=0)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: object
    spec: P

    def shard(self, array):
        return shard_local(array, self.spec, self.mesh)


def named(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


# --------------------------------------------------------------------------
# global view: DTensor placements from the reference's specs
# --------------------------------------------------------------------------
@contextlib.contextmanager
def implicit_replication():
    """Plain tensors taken as replicated DTensors in DTensor ops (torch's
    ``implicit_replication``, which switches the flag off on exit even
    inside another such block; this one restores it)."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def is_spec(x) -> bool:
    return isinstance(x, P)


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of :class:`P` (a spec is a leaf
    here, though it is a tuple) and the matching leaves of ``trees``;
    ``None`` where the reference's out specs leave a subtree free stays
    ``None``."""
    if specs is None or is_spec(specs):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    if dataclasses.is_dataclass(specs):
        return type(specs)(*(
            map_specs(fn, getattr(specs, f.name),
                      *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(specs)))
    kids = [map_specs(fn, s, *(t[i] for t in trees))
            for i, s in enumerate(specs)]
    return type(specs)(*kids) if hasattr(specs, "_fields") \
        else type(specs)(kids)


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (one per mesh axis):
    an axis that splits tensor dim i is ``Shard(i)``, every other axis
    ``Replicate()``, and so is an axis of size 1 (the same layout, and
    DTensor's view rules refuse to reshape a dim "sharded" over one
    rank).  A dim split over several axes is split over them in mesh
    order (the reference's tuples list them so)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(spec or ()):
        axes = axes_of(entry)
        idx = [mesh.axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in mesh order "
                             f"{mesh.axis_names}")
        for i, a in zip(idx, axes):
            if mesh.size(a) > 1:
                out[i] = Shard(dim)
    return out


def _local_extent(size: int, entry, mesh) -> tuple[int, int]:
    """(offset, length) of this rank's block of a dim of ``size`` split
    over ``entry``'s axes, in ``torch.chunk``'s blocks (DTensor's)."""
    off, length = 0, size
    for axis in axes_of(entry):
        n, i = mesh.size(axis), mesh.index(axis)
        chunk = -(-length // n)
        start = min(length, i * chunk)
        off, length = off + start, max(0, min(length, start + chunk) - start)
    return off, length


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global ``t`` under ``spec``: a slice of a
    real tensor, a fresh ``meta`` tensor of the block's shape for a meta
    one."""
    entries = tuple(spec or ()) + (None,) * (t.dim() - len(spec or ()))
    ext = [_local_extent(t.shape[d], e, mesh) for d, e in enumerate(entries)]
    if t.device.type == "meta":
        return torch.empty([n for _, n in ext], dtype=t.dtype,
                           device="meta")
    return t[tuple(slice(o, o + n) for o, n in ext)]


def distribute(tree, specs, mesh):
    """A tree of global tensors (real, every rank holding the whole, or
    ``meta``) as DTensors over ``mesh.device_mesh`` placed by ``specs``:
    each rank keeps only its block (no collective)."""
    from torch.distributed.tensor import DTensor

    def one(spec, t):
        if spec is None:
            spec = P()
        loc = local_block(t, spec, mesh)
        if loc.device.type != "meta":
            loc = loc.contiguous()
        return DTensor.from_local(loc, mesh.device_mesh,
                                  placements(spec, mesh), run_check=False,
                                  shape=t.shape, stride=_contiguous(t.shape))

    return map_specs(one, specs, tree)


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(stride))


def redistribute(tree, specs, mesh):
    """A tree of DTensors moved to the placements of ``specs``."""
    return map_specs(
        lambda spec, t: t.redistribute(mesh.device_mesh,
                                       placements(spec, mesh)),
        specs, tree)


def _to_local(x):
    """A replicated dataclass argument (LLSP params) with its DTensor
    leaves unwrapped: ``local_map`` passes a dataclass through whole."""
    if dataclasses.is_dataclass(x):
        return type(x)(*(_to_local(getattr(x, f.name))
                         for f in dataclasses.fields(x)))
    return x.to_local() if hasattr(x, "to_local") else x


def local_region(fn, mesh, in_specs, out_specs, in_grad_specs=None):
    """``fn`` (a local-view function: each rank's blocks in, its blocks
    out, collectives over ``mesh``'s groups inside) as a function of
    DTensors: ``torch.distributed.tensor.experimental.local_map`` with
    the placements of the reference's ``shard_map`` ``in_specs`` and
    ``out_specs`` (inputs moved to them first).  ``in_grad_specs`` gives,
    for each differentiable input, the placements of its gradient (a
    ``Partial`` over the axes whose ranks each add a part of it, as a
    replicated weight read by batch-split work); by default its input's.
    A ``None`` argument stays ``None``; a dataclass argument must be
    replicated; a tree argument (a parameter dict) takes its spec for
    every leaf.  An out spec may also be a list of placements (a
    ``Partial`` output).  Called on plain tensors, ``fn`` runs as it
    is."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_leaves

    def call(*args):
        if not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        args = tuple(_to_local(a) if dataclasses.is_dataclass(a) else a
                     for a in args)
        grads = in_grad_specs or (None,) * len(args)
        in_pl, grad_pl = [], []
        for arg, spec, gspec in zip(args, in_specs, grads):
            for a in tree_leaves(arg):      # a tree: one spec for all
                if isinstance(a, DTensor):
                    pl = tuple(placements(spec, mesh))
                    in_pl.append(pl)
                    grad_pl.append(pl if gspec is None else tuple(gspec))
                else:
                    in_pl.append(None)
                    grad_pl.append(None)
        out_pl = tuple(tuple(placements(s, mesh) if is_spec(s) else s)
                       for s in out_specs)
        return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                         in_grad_placements=tuple(grad_pl),
                         device_mesh=mesh.device_mesh,
                         redistribute_inputs=True)(*args)

    return call


class _Constrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.pl), None


def constrain(x, spec, mesh):
    """``x`` moved to the placements of ``spec``, and its gradient to the
    same placements in the backward (``jax.lax.with_sharding_constraint``
    constrains both).  DTensor picks each op's placements from its inputs
    alone: without a constraint, the replicated gradient that a loss's
    sum hands back stays replicated, and every rank would compute the
    whole batch's backward.  A plain tensor passes through."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, tuple(placements(spec, mesh)))


def sharded_axes(t, dim: int) -> tuple:
    """The mesh axes over which the DTensor ``t`` splits tensor dim
    ``dim``, in mesh order."""
    from torch.distributed.tensor import Shard

    names = t.device_mesh.mesh_dim_names
    return tuple(n for n, p in zip(names, t.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def blockwise(fn, x):
    """``fn`` of ``x`` where ``fn`` acts within each rank's block and keeps
    its shape (an elementwise op, a roll along a dim the placements leave
    whole); for a DTensor, on each rank's block with ``x``'s placements (a
    partial sum summed first): the region for such an op that DTensor has
    no sharding rule for."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(x, DTensor):
        return fn(x)
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def partial_over(spec, mesh, axes) -> list:
    """``spec``'s placements with each of ``axes`` that it leaves whole
    made ``Partial``: the gradient of a weight that the ranks along those
    axes read whole, each for its own block of the batch."""
    from torch.distributed.tensor import Partial, Replicate

    out = placements(spec, mesh)
    for a in axes:
        i = mesh.axis_names.index(a)
        if isinstance(out[i], Replicate):
            out[i] = Partial()
    return out


def full(tree):
    """The global value of every DTensor leaf (a gather where sharded)."""
    from .collectives import tree_map

    return tree_map(lambda t: t.full_tensor()
                    if hasattr(t, "full_tensor") else t, tree)


def zero1_specs(specs, shapes, mesh):
    """Optimizer-moment sharding: the param spec with the first free dim
    also split over ``data`` when it divides (ZeRO-1); unchanged where
    ``data`` already appears (FSDP weights).  The reference's rule."""
    dsize = mesh.shape["data"]

    def one(spec, s) -> P:
        parts = tuple(spec) + (None,) * (len(s.shape) - len(tuple(spec)))
        flat = []
        for p_ in parts:
            if p_ is None:
                flat.append(None)
            elif isinstance(p_, tuple):
                flat.extend(p_)
            else:
                flat.append(p_)
        if "data" in flat:
            return spec
        for i, p_ in enumerate(parts):
            if p_ is None and s.shape[i] % dsize == 0 \
                    and s.shape[i] >= dsize:
                return P(*parts[:i], "data", *parts[i + 1:])
        return spec

    return map_specs(one, specs, shapes)


def opt_specs(param_specs_tree, params_abs, mesh):
    """AdamW state specs: the step replicated, both moments ZeRO-1."""
    from repro_torch.optim.adamw import AdamWState

    z = zero1_specs(param_specs_tree, params_abs, mesh)
    return AdamWState(step=P(), mu=z, nu=z)
