"""Sharded checkpoint store: tree -> one ``.npy`` a leaf + JSON manifest
(port of ``repro.ckpt.store``; the files on disk are the reference's).

* one file a leaf, named as the reference names it (``0001_0_table.npy``:
  the leaf's index, then its path of dict keys, sequence indices and
  ``NamedTuple`` field names joined by ``_``), in the reference's leaf
  order (dict keys sorted), so either package restores the other's;
* atomic publish: a checkpoint directory is staged under ``.tmp`` and
  renamed only after the manifest fsyncs, so a crashed writer never leaves
  a half-checkpoint that restore could pick up;
* generation GC: keep the last ``keep`` checkpoints;
* restore validates the leaf count and shapes against the manifest and
  puts each leaf on its ``tree_like`` leaf's device and dtype.

A dtype numpy lacks (bfloat16, the float8 types) is stored as the
reference stores it: a raw ``uint16`` (``uint8``) view with the dtype's
name in the manifest and ``raw_view`` true; it is read back through
``torch.Tensor.view``, with no ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.collectives import tree_flatten, \
    tree_flatten_with_path, tree_unflatten


def _leaf_files(tree) -> list[tuple[str, Any]]:
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        name = "_".join(str(p) for p in path)
        name = name.replace("/", "_").replace(".", "_") or "leaf"
        out.append((name, leaf))
    return out


def _raw_view_dtype(t: torch.Tensor) -> Optional[str]:
    """The dtype name of a tensor numpy cannot hold (stored as a raw view),
    else None."""
    if t.dtype.is_floating_point and t.dtype not in (
            torch.float16, torch.float32, torch.float64):
        return str(t.dtype).removeprefix("torch.")
    return None


def _host_array(leaf) -> tuple[np.ndarray, str, bool]:
    """(the array to write, the manifest's dtype name, raw_view)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype), False
    t = leaf.detach().cpu()
    name = _raw_view_dtype(t)
    if name is None:
        arr = t.numpy()
        return arr, str(arr.dtype), False
    width = t.element_size()
    raw = t.view(torch.int16 if width == 2 else torch.uint8).numpy()
    return raw.view(np.uint16 if width == 2 else np.uint8), name, True


def save(tree, step: int, root: str, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Write checkpoint ``root/step_<N>`` atomically. Returns the final
    path."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(_leaf_files(tree)):
        arr, dtype_name, raw_view = _host_array(leaf)
        fn = f"{i:04d}_{name}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"file": fn, "shape": list(arr.shape), "dtype": dtype_name,
             "raw_view": raw_view})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(root, keep)
    return final


def _gc(root: str, keep: int) -> None:
    ckpts = sorted(
        d for d in os.listdir(root)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(root, d))


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    ckpts = sorted(
        d for d in os.listdir(root)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(root, d, "manifest.json"))
    )
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1])


def _load_leaf(path: str, meta: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if not meta.get("raw_view"):
        return torch.from_numpy(arr)
    # a raw byte view of a dtype numpy lacks: back through torch's view
    want = getattr(torch, meta["dtype"])
    signed = {np.dtype(np.uint16): np.int16, np.dtype(np.uint8): np.uint8}
    return torch.from_numpy(arr.view(signed[arr.dtype])).view(want)


def restore(tree_like, root: str, step: Optional[int] = None
            ) -> tuple[Any, int, dict]:
    """Restore into the structure of ``tree_like``, each leaf on its
    ``tree_like`` leaf's device and dtype. Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, structure = tree_flatten(tree_like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"leaf count mismatch: tree {len(leaves)} vs manifest "
            f"{len(manifest['leaves'])}")
    out = []
    for leaf, meta in zip(leaves, manifest["leaves"]):
        t = _load_leaf(path, meta)
        if list(t.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {meta['file']}")
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(structure, out), manifest["step"], \
        manifest.get("extra", {})
