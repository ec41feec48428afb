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

import dataclasses

import torch

from .collectives import all_gather


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


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_of(entry, mesh) -> tuple[int, int]:
    """(this rank's block index, number of blocks) of a dimension whose
    spec entry is ``entry``."""
    idx, n = 0, 1
    for axis in _axes(entry):
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
                             f"{_axes(entry)} ({n} blocks)")
        step = size // n
        index.append(slice(idx * step, (idx + 1) * step))
    return array[tuple(index)]


def gather_axes(local: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The global tensor of which each rank holds the dim-0 block under
    ``P(axes)``: gathered over the innermost axis first, each in axis
    order."""
    out = local
    for axis in reversed(_axes(axes)):
        out = torch.cat(all_gather(out, mesh.group(axis)), dim=0)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: object
    spec: P

    def shard(self, array):
        return shard_local(array, self.spec, self.mesh)


def named(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)
