"""Histogram gradient-boosted decision trees, the LLSP model class (port of
``repro.core.gbdt``).

* ``GBDTRegressor.fit`` — numpy histogram boosting, offline on the CPU; a
  verbatim copy of the reference's training so the same features give the
  same trees.
* ``GBDTParams`` / :func:`predict` — a flat-array ensemble whose inference
  is plain torch (gather-based descent, no control flow), so the router and
  pruning models run on the serving device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class GBDTParams:
    """Flat encoding of a boosted ensemble: trees are full implicit binary
    trees (node i has children 2i+1 / 2i+2); ``feature`` < 0 marks a leaf,
    whose ``value`` is the prediction.  Stacked params carry a leading
    level axis."""

    feature: torch.Tensor    # (T, n_nodes) int32, -1 => leaf
    threshold: torch.Tensor  # (T, n_nodes) f32
    value: torch.Tensor      # (T, n_nodes) f32
    base: torch.Tensor       # () f32
    lr: torch.Tensor         # () f32

    def to(self, device) -> "GBDTParams":
        return GBDTParams(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def predict(params: GBDTParams, x: torch.Tensor) -> torch.Tensor:
    """Vectorized ensemble inference.  x: (B, F) -> (B,)."""
    b = x.shape[0]
    t, n_nodes = params.feature.shape
    depth = int(np.log2(n_nodes + 1)) - 1
    t_idx = torch.arange(t, device=x.device)[None, :]
    node = torch.zeros((b, t), dtype=torch.int64, device=x.device)
    for _ in range(depth):
        feat = params.feature[t_idx, node]
        thr = params.threshold[t_idx, node]
        fv = torch.gather(x, 1, torch.clamp_min(feat, 0).long())
        child = torch.where(fv <= thr, 2 * node + 1, 2 * node + 2)
        node = torch.where(feat < 0, node, child)
    val = params.value[t_idx, node]
    return params.base + params.lr * torch.sum(val, dim=1)


def predict_stacked(stacked: GBDTParams, level: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Inference through a stack of ensembles (one per LLSP level);
    ``level`` (B,) selects the ensemble per row."""
    b = x.shape[0]
    _, t, n_nodes = stacked.feature.shape
    depth = int(np.log2(n_nodes + 1)) - 1
    t_idx = torch.arange(t, device=x.device)[None, :]
    lvl = level.long()[:, None]
    node = torch.zeros((b, t), dtype=torch.int64, device=x.device)
    for _ in range(depth):
        feat = stacked.feature[lvl, t_idx, node]
        thr = stacked.threshold[lvl, t_idx, node]
        fv = torch.gather(x, 1, torch.clamp_min(feat, 0).long())
        child = torch.where(fv <= thr, 2 * node + 1, 2 * node + 2)
        node = torch.where(feat < 0, node, child)
    val = stacked.value[lvl, t_idx, node]
    lv = level.long()
    return stacked.base[lv] + stacked.lr[lv] * torch.sum(val, dim=1)


def stack_params(models: list[GBDTParams]) -> GBDTParams:
    """Stack same-shaped ensembles along a new leading (level) axis."""
    return GBDTParams(*(torch.stack([getattr(m, f.name) for m in models])
                        for f in dataclasses.fields(GBDTParams)))


class GBDTRegressor:
    """Histogram GBDT with squared loss (numpy; copy of the reference)."""

    def __init__(
        self,
        n_trees: int = 100,
        max_depth: int = 5,
        lr: float = 0.2,
        n_bins: int = 64,
        min_samples_leaf: int = 8,
        lambda_l2: float = 1.0,
        seed: int = 0,
    ):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.lr = lr
        self.n_bins = n_bins
        self.min_samples_leaf = min_samples_leaf
        self.lambda_l2 = lambda_l2
        self.seed = seed
        self.params: Optional[GBDTParams] = None

    # ---- binning -----------------------------------------------------------
    def _make_bins(self, X: np.ndarray) -> np.ndarray:
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        edges = np.quantile(X, qs, axis=0)                        # (B-1, F)
        return np.ascontiguousarray(edges.T)                      # (F, B-1)

    def _bin(self, X: np.ndarray) -> np.ndarray:
        F = X.shape[1]
        out = np.empty(X.shape, dtype=np.int32)
        for f in range(F):
            out[:, f] = np.searchsorted(self.bin_edges_[f], X[:, f], side="left")
        return out

    # ---- tree growth -------------------------------------------------------
    def _fit_tree(self, binned: np.ndarray, g: np.ndarray):
        """Depth-wise greedy growth on gradients g. Returns flat node arrays."""
        n, F = binned.shape
        B = self.n_bins
        n_nodes = 2 ** (self.max_depth + 1) - 1
        feature = np.full(n_nodes, -1, dtype=np.int32)
        threshold = np.zeros(n_nodes, dtype=np.float32)
        value = np.zeros(n_nodes, dtype=np.float32)

        node_of = np.zeros(n, dtype=np.int64)                     # sample -> node
        lam = self.lambda_l2
        value[0] = g.sum() / (n + lam)

        level_nodes = [0]
        for depth in range(self.max_depth):
            if not level_nodes:
                break
            # histograms for every active node x feature x bin in one pass
            # flat key = node_slot * F * B + f * B + bin
            slot = {nd: i for i, nd in enumerate(level_nodes)}
            slots = np.array([slot.get(nd, -1) for nd in range(n_nodes)])
            s = slots[node_of]                                    # (n,)
            act = s >= 0
            sa, ba, ga = s[act], binned[act], g[act]
            S = len(level_nodes)
            keys = (sa[:, None] * F + np.arange(F)[None, :]) * B + ba
            hist_g = np.bincount(keys.ravel(), weights=np.repeat(ga, F),
                                 minlength=S * F * B).reshape(S, F, B)
            hist_n = np.bincount(keys.ravel(), minlength=S * F * B).reshape(S, F, B)

            next_level: list[int] = []
            csum_g = np.cumsum(hist_g, axis=2)
            csum_n = np.cumsum(hist_n, axis=2)
            for nd in level_nodes:
                si = slot[nd]
                tot_g = csum_g[si, 0, -1]
                tot_n = csum_n[si, 0, -1]
                if tot_n < 2 * self.min_samples_leaf:
                    value[nd] = tot_g / (tot_n + lam) if tot_n else 0.0
                    continue
                gl = csum_g[si, :, :-1]                           # (F, B-1)
                nl = csum_n[si, :, :-1]
                gr = tot_g - gl
                nr = tot_n - nl
                valid = (nl >= self.min_samples_leaf) & (nr >= self.min_samples_leaf)
                gain = gl * gl / (nl + lam) + gr * gr / (nr + lam) - tot_g * tot_g / (tot_n + lam)
                gain = np.where(valid, gain, -np.inf)
                fi, bi = np.unravel_index(np.argmax(gain), gain.shape)
                if not np.isfinite(gain[fi, bi]) or gain[fi, bi] <= 1e-12:
                    value[nd] = tot_g / (tot_n + lam)
                    continue
                feature[nd] = fi
                edges = self.bin_edges_[fi]
                threshold[nd] = edges[min(bi, len(edges) - 1)]
                lc, rc = 2 * nd + 1, 2 * nd + 2
                mask = (node_of == nd)
                go_left = binned[mask, fi] <= bi
                idx = np.where(mask)[0]
                node_of[idx[go_left]] = lc
                node_of[idx[~go_left]] = rc
                value[lc] = gl[fi, bi] / (nl[fi, bi] + lam)
                value[rc] = gr[fi, bi] / (nr[fi, bi] + lam)
                next_level += [lc, rc]
            level_nodes = next_level
        return feature, threshold, value, node_of

    # ---- boosting ----------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDTRegressor":
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float64)
        self.bin_edges_ = self._make_bins(X)
        binned = self._bin(X)
        base = float(y.mean())
        F_pred = np.full(y.shape, base)
        feats, thrs, vals = [], [], []
        for _ in range(self.n_trees):
            g = y - F_pred
            f, t, v, node_of = self._fit_tree(binned, g)
            feats.append(f)
            thrs.append(t)
            vals.append(v)
            F_pred = F_pred + self.lr * v[node_of]
        self.params = GBDTParams(
            feature=torch.from_numpy(np.stack(feats)),
            threshold=torch.from_numpy(np.stack(thrs)),
            value=torch.from_numpy(np.stack(vals).astype(np.float32)),
            base=torch.tensor(base, dtype=torch.float32),
            lr=torch.tensor(self.lr, dtype=torch.float32),
        )
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("fit first")
        x = torch.from_numpy(np.asarray(X, dtype=np.float32))
        return predict(self.params, x).numpy()
