"""Faults planted in the program underneath a run, to show that the check
comes out not correct with them: the tests plant them on the CPU, and
``readings.py`` plants them on the card to read the checked numbers at a
cell's own size.  Each patches the program for the duration of a
``with planted(name):`` block.

* ``k23_init``: K23's Lloyd loop stops after its first assignment, so
  every split of the build takes the cells of its initial centroids: a
  k-means step that returns its state unchanged;
* ``llsp_untrained``: LLSP's boosted trees are left as they start, every
  leaf value 0, so each ensemble gives its base (the mean of its labels);
* ``llsp_level``: LLSP's router sends each query one level lower (level 0
  stays), so most queries are served with fewer probes than trained.
"""
from __future__ import annotations

import contextlib
import dataclasses


def _k23_init():
    from repro_torch.kernels import ops

    orig = ops.kmeans_batched

    def first_assignment(x, pts, offs, k, init, iters, **kw):
        return orig(x, pts, offs, k, init, 1, **kw)

    ops.kmeans_batched = first_assignment
    return lambda: setattr(ops, "kmeans_batched", orig)


def _llsp_untrained():
    import torch
    from repro_torch.core.gbdt import GBDTRegressor

    orig = GBDTRegressor.fit

    def fit(self, *a, **kw):
        out = orig(self, *a, **kw)
        self.params = dataclasses.replace(
            self.params, value=torch.zeros_like(self.params.value))
        return out

    GBDTRegressor.fit = fit
    return lambda: setattr(GBDTRegressor, "fit", orig)


def _llsp_level():
    import torch
    from repro_torch.core import llsp

    orig = llsp.route

    def route(params, queries, topk):
        return torch.clamp_min(orig(params, queries, topk) - 1, 0)

    llsp.route = route
    return lambda: setattr(llsp, "route", orig)


FAULTS = {"k23_init": _k23_init, "llsp_untrained": _llsp_untrained,
          "llsp_level": _llsp_level}


@contextlib.contextmanager
def planted(name: str):
    undo = FAULTS[name]()
    try:
        yield
    finally:
        undo()
