"""Per-device cost of a program over DTensors, counted on the ops each
rank runs (the port's counterpart of ``repro.launch.hlo_analysis``, which
reads the same totals from compiled XLA HLO text).

:class:`OpCounter` is a ``TorchDispatchMode``.  An op on DTensors reaches
it first with the DTensors (global shapes): it notes that op's flops as
the global count and steps aside, and DTensor then runs the rank's local
ops, collectives included, which reach it again with plain tensors.  Only
those are the device's work:

  flops  - matrix products by ``torch.utils.flop_counter``'s formulas
           (2 * M * N * K), plus 1 flop per output element of any other op
           that is not a view or plumbing (the reference's crude
           elementwise estimate);
  bytes  - each local op's tensor inputs and outputs, skipping views and
           plumbing (the reference's proxy for HBM traffic);
  coll   - per collective kind: result bytes x the reference's per-device
           traffic factor (all-gather 1x, all-reduce 2x (ring),
           reduce-scatter 1x, all-to-all 1x, collective-permute 1x);
  peak   - the largest sum of live local storages made in the run (each
           freed when its last tensor goes), plus the arguments' bytes.

A DTensor's sharding propagation runs ops on fake or meta tensors of the
global shapes; those are skipped (fake tensors as ``torch.utils._debug_mode``
skips them; the propagation itself runs with the counter's mode off).
Python loops are unrolled as they run, so no trip count is needed.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_COLL_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# collective op name (``_c10d_functional`` and ``c10d``) -> the
# reference's kind
_COLL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
}

# no device work: allocation without a write, metadata, aliasing
_PLUMBING = {
    "empty", "empty_like", "empty_strided", "detach", "alias", "lift_fresh",
    "_to_copy_meta", "wait_tensor", "_wrap_tensor_autograd", "t",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "device",
    "is_same_size", "_local_scalar_dense", "set_",
}


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    global_flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLL_FACTOR})
    coll_ops: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLL_FACTOR})
    n_local_ops: int = 0
    arg_bytes: int = 0
    peak_bytes: int = 0

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll.values()))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's local
    block)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            total += _nbytes(getattr(t, "_local_tensor", t))
    return total


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _flop_registry():
    from torch.utils.flop_counter import flop_registry

    return flop_registry


class OpCounter(TorchDispatchMode):
    """Counts a program's local ops while it runs (see the module doc);
    ``totals`` holds the result.  ``args`` (a tree) are counted as live
    from the start."""

    def __init__(self, args=()):
        super().__init__()
        self.totals = Totals(arg_bytes=local_bytes(args))
        self.registry = _flop_registry()
        # the arguments' storages are counted in arg_bytes: a view of one
        # (a layer's slice of a stacked weight, a cache row) is no new byte
        self._args = {_storage_key(getattr(t, "_local_tensor", t))
                      for t in tree_leaves(args) if isinstance(t, torch.Tensor)}
        self._live: dict = {}
        self._cur = 0
        self.totals.peak_bytes = self.totals.arg_bytes

    # -- DTensor's sharding propagation runs ops on tensors of the global
    # shapes (meta tensors, not fake ones, in recent torch): no device
    # work, so the counter steps out of the way while it runs
    def __enter__(self):
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator
        inner = getattr(prop, "propagate_op_sharding_non_cached", None)
        self._patched = None
        if inner is not None:
            from torch.utils._python_dispatch import _disable_current_modes

            def quiet(*a, **k):
                with _disable_current_modes():
                    return inner(*a, **k)

            prop.propagate_op_sharding_non_cached = quiet
            self._patched = prop
        return super().__enter__()

    def __exit__(self, *exc):
        if self._patched is not None:
            del self._patched.propagate_op_sharding_non_cached
            self._patched = None
        return super().__exit__(*exc)

    # -- live storages --------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key is None or key in self._args:
            return
        st = t.untyped_storage()
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [st.nbytes(), 0]
            self._cur += entry[0]
            peak = self.totals.arg_bytes + self._cur
            if peak > self.totals.peak_bytes:
                self.totals.peak_bytes = peak
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self._cur -= entry[0]
            del self._live[key]

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if func.overloadpacket in self.registry:
                self.totals.global_flops += self._global_flops(func, args,
                                                               kwargs)
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _global_flops(self, func, args, kwargs) -> float:
        """The op's flops at its global shapes (what
        ``FlopCounterMode`` reports over DTensors)."""
        from torch.utils._pytree import tree_map

        meta = lambda x: (torch.empty(x.shape, dtype=x.dtype, device="meta")
                          if isinstance(x, torch.Tensor) else x)
        a, k = tree_map(meta, (args, kwargs))
        with torch.utils._python_dispatch._disable_current_modes():
            out = func(*a, **k)
        return float(self.registry[func.overloadpacket](*a, **k,
                                                         out_val=out))

    def _count(self, func, args, kwargs, out) -> None:
        tot = self.totals
        name = func.overloadpacket.__name__
        ns = func.namespace
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if ns in ("_c10d_functional", "c10d"):
            kind = _COLL_KIND.get(name)
            if kind is not None:
                res = outs if ns == "_c10d_functional" else \
                    [t for t in tree_leaves(args[0])
                     if isinstance(t, torch.Tensor)]
                b = sum(_nbytes(t) for t in res)
                tot.coll[kind] += b * _COLL_FACTOR[kind]
                tot.coll_ops[kind] += 1
            for t in outs:
                self._track(t)
            return
        is_view = getattr(func, "is_view", False)
        for t in outs:
            self._track(t)
        if is_view or name in _PLUMBING:
            return
        tot.n_local_ops += 1
        pkt = func.overloadpacket
        if pkt in self.registry:
            try:
                tot.flops += float(self.registry[pkt](*args, **kwargs,
                                                      out_val=out))
            except Exception:  # noqa: BLE001 — count it as elementwise
                tot.flops += sum(t.numel() for t in outs)
        else:
            tot.flops += sum(t.numel() for t in outs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        tot.bytes += sum(_nbytes(t) for t in ins) + \
            sum(_nbytes(t) for t in outs)
