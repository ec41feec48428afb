"""Distributed-optimization collectives (port of
``repro.distributed.collectives``).

* int8 compressed all-reduce with error feedback: each participant
  quantizes its tensor to int8 with a per-tensor scale, the int8 payload is
  summed as int32, dequantized with the participants' mean scale, and the
  local quantization residual goes into an error-feedback buffer that the
  caller adds back next step;
* ``bucketed_psum``: many small tensors fused into flat buckets, one
  collective a bucket.

Where the reference names a mesh axis, these take the axis's process
subgroup (``Mesh.group(axis)``).  A tree is nested dicts, lists and tuples
of tensors, flattened in the reference's ``tree_flatten`` order (dict keys
sorted).

:func:`all_gather` and :func:`all_reduce` are the primitives every
collective of the port goes through.  A gloo group takes CUDA tensors only
for some collectives, so on a gloo group these copy a CUDA tensor to host
memory, run the collective there and copy the result back (always, and
only for gloo: ``Mesh.host_staged``); NCCL runs on the card's tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group) -> list:
    """Every group member's ``t``, in group-rank order (the axis order of a
    mesh subgroup)."""
    src = t.cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every group member's ``t`` (a new tensor)."""
    buf = t.cpu().clone() if _staged(t, group) else t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q, scale).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, group,
                    error: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce mean with error feedback over ``group``: returns
    (mean-reduced x, new error buffer); ``error`` None is a zero buffer."""
    if error is None:
        error = torch.zeros_like(x)
    x_ef = x + error
    q, scale = quantize_int8(x_ef)
    new_error = x_ef - dequantize_int8(q, scale)   # residual kept locally
    # reduce in int32 so >127 participants cannot overflow int8
    summed = all_reduce(q.to(torch.int32), group)
    scale_sum = all_reduce(scale, group)          # participants may differ
    n = torch.tensor(float(dist.get_world_size(group)), dtype=x.dtype,
                     device=x.device)
    mean_scale = scale_sum / n
    out = summed.to(torch.float32) * mean_scale / n
    return out.to(x.dtype), new_error


def tree_flatten(tree) -> tuple[list, object]:
    """(leaves, structure) in ``jax.tree_util.tree_flatten``'s order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for s in subs for leaf in s[0]],
                ("dict", keys, [s[1] for s in subs]))
    if isinstance(tree, (list, tuple)):
        subs = [tree_flatten(v) for v in tree]
        return ([leaf for s in subs for leaf in s[0]],
                (type(tree), [s[1] for s in subs]))
    return [tree], None


def tree_unflatten(structure, leaves: list):
    """The tree of ``structure`` (from :func:`tree_flatten`) over
    ``leaves``."""
    return _build(structure, iter(leaves))


def _build(s, it):
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding the leaves (a step's parameters on the card) until the
    # cyclic garbage collector happens to run
    if s is None:
        return next(it)
    if s[0] == "dict":
        return {k: _build(c, it) for k, c in zip(s[1], s[2])}
    children = [_build(c, it) for c in s[1]]
    if hasattr(s[0], "_fields"):                  # a NamedTuple
        return s[0](*children)
    return s[0](children)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree of ``rest``), as ``jax.tree.map``: the result has ``tree``'s
    structure."""
    leaves, structure = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees do not match")
    return tree_unflatten(structure,
                          [fn(*xs) for xs in zip(leaves, *others)])


def tree_flatten_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in :func:`tree_flatten`'s order; a path holds, for
    each level, the dict key, the sequence index or the ``NamedTuple``
    field name, as ``jax.tree_util.tree_flatten_with_path`` names them."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        return [pl for name, v in zip(names, tree)
                for pl in tree_flatten_with_path(v, path + (name,))]
    return [(path, tree)]


def compressed_psum_tree(grads, group, errors=None):
    """Tree-mapped compressed psum; ``errors`` matches ``grads`` (or None).
    Returns (mean-reduced tree, new error tree)."""
    leaves, structure = tree_flatten(grads)
    err_leaves = [None] * len(leaves) if errors is None \
        else tree_flatten(errors)[0]
    if len(err_leaves) != len(leaves):
        raise ValueError("errors do not match the gradient tree")
    outs, new_errs = [], []
    for g, e in zip(leaves, err_leaves):
        o, ne = compressed_psum(g, group, e)
        outs.append(o)
        new_errs.append(ne)
    return tree_unflatten(structure, outs), tree_unflatten(structure, new_errs)


def bucketed_psum(grads, group, bucket_bytes: int = 64 << 20):
    """Mean all-reduce of a tree with small leaves fused into flat f32
    buckets: one collective a bucket instead of one a leaf."""
    leaves, structure = tree_flatten(grads)
    n = float(dist.get_world_size(group))
    flats, shapes, dtypes = [], [], []
    for g in leaves:
        shapes.append(g.shape)
        dtypes.append(g.dtype)
        flats.append(g.to(torch.float32).reshape(-1))
    buckets, cur, cur_bytes = [], [], 0
    for f in flats:
        cur.append(f)
        cur_bytes += f.numel() * 4
        if cur_bytes >= bucket_bytes:
            buckets.append(torch.cat(cur))
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(torch.cat(cur))
    reduced = [all_reduce(b, group) / n for b in buckets]
    flat_all = torch.cat(reduced) if len(reduced) > 1 else reduced[0]
    outs, off = [], 0
    for shape, dt in zip(shapes, dtypes):
        size = 1
        for s in shape:
            size *= s
        outs.append(flat_all[off:off + size].reshape(shape).to(dt))
        off += size
    return tree_unflatten(structure, outs)
