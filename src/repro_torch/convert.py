"""Carry the reference package's index and LLSP state into the port.

The JAX package's parameters arrive as numpy arrays (``np.asarray`` of each
field) and leave as the port's dataclasses of tensors on ``device``.  This
module imports nothing from the reference, so it runs where JAX is absent.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.llsp import LLSPParams
from repro_torch.device import DeviceLike, resolve_device

GBDT_FIELDS = ("feature", "threshold", "value", "base", "lr")


def _tensor(a, dtype, dev: torch.device) -> torch.Tensor:
    arr = np.array(a, dtype=dtype, order="C")       # owned, writable copy
    return torch.from_numpy(arr).to(dev)


def ivf_index(centroids, postings, posting_ids, *, group_centroids=None,
              group_members=None, q8=None, qscale=None, qnorm2=None,
              device: DeviceLike = None) -> IVFIndex:
    """An :class:`IVFIndex` from the reference's arrays, including the
    optional two-level group quantizer and int8 residual payload."""
    dev = resolve_device(device)
    opt = lambda a, dt: None if a is None else _tensor(a, dt, dev)
    return IVFIndex(_tensor(centroids, np.float32, dev),
                    _tensor(postings, np.float32, dev),
                    _tensor(posting_ids, np.int32, dev),
                    group_centroids=opt(group_centroids, np.float32),
                    group_members=opt(group_members, np.int32),
                    q8=opt(q8, np.int8), qscale=opt(qscale, np.float32),
                    qnorm2=opt(qnorm2, np.float32))


def gbdt_params(arrays: Mapping[str, np.ndarray], *,
                device: DeviceLike = None) -> GBDTParams:
    """A :class:`GBDTParams` from ``{feature, threshold, value, base, lr}``
    arrays (plain or stacked along a leading level axis)."""
    dev = resolve_device(device)
    dtypes = {"feature": np.int32}
    return GBDTParams(**{f: _tensor(arrays[f], dtypes.get(f, np.float32), dev)
                         for f in GBDT_FIELDS})


def llsp_params(router: Mapping[str, np.ndarray],
                pruners: Mapping[str, np.ndarray], levels,
                *, device: DeviceLike = None) -> LLSPParams:
    """An :class:`LLSPParams` from the router's and the stacked pruners'
    GBDT arrays and the level bounds."""
    dev = resolve_device(device)
    return LLSPParams(gbdt_params(router, device=dev),
                      gbdt_params(pruners, device=dev),
                      _tensor(levels, np.int32, dev))


def gbdt_arrays(params) -> dict:
    """``{field: np.ndarray}`` of any object with the GBDT fields (the
    reference's ``GBDTParams`` or the port's)."""
    return {f: np.asarray(getattr(params, f)) for f in GBDT_FIELDS}


def llsp_from_reference(params, *, device: DeviceLike = None
                        ) -> Optional[LLSPParams]:
    """The port's LLSP params from an object shaped like the reference's
    ``LLSPParams`` (``router``, ``pruners``, ``levels``); None stays None."""
    if params is None:
        return None
    return llsp_params(gbdt_arrays(params.router),
                       gbdt_arrays(params.pruners),
                       np.asarray(params.levels), device=device)
