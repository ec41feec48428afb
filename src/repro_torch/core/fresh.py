"""Freshness layer (port of ``repro.core.fresh``): the paper's §6.2
deployment design for updates.

  * the main clustered index, periodically rebuilt;
  * recent insertions in an auxiliary in-memory buffer, searched by brute
    force (one matrix product on the device);
  * deletions tracked by a tombstone bitmap;
  * queries search both, merge candidates and filter tombstones;
  * the rebuild folds the delta, drops tombstones and swaps.

Plain torch on tensors of an explicit device: the reference computes the
merge outside any Pallas kernel, so ``squared_l2`` stays a matrix product
here.  Top-k and the merge use ``core.distance``'s ``topk_smallest`` and
``merge_candidate_topk`` (stable sorts: lowest index first among ties).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .distance import merge_candidate_topk, squared_l2, topk_smallest
from .ivf import IVFIndex, search_flat


def merge_fresh(main_d: torch.Tensor, main_i: torch.Tensor,
                queries: torch.Tensor, delta_vecs: torch.Tensor,
                delta_ids: torch.Tensor, tombstone: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The freshness merge (§6.2): main candidates (B, >=k) plus the delta
    buffer by brute force, tombstones filtered at the merge.  One
    definition shared by ``FreshIndex.search``, ``search_leveled`` and the
    serving pipeline's dispatch.

    Takes k from the delta side too, so tombstoned results cannot starve
    the merge; ids outside the tombstone bitmap are clipped (a guard: every
    live id fits the epoch's id capacity)."""
    d_delta = squared_l2(queries, delta_vecs)               # (B, cap)
    live_slot = delta_ids >= 0
    d_delta = torch.where(live_slot[None, :], d_delta, float("inf"))
    dd, pos = topk_smallest(d_delta, min(k, delta_vecs.shape[0]))
    di = delta_ids[pos]
    alld = torch.cat([main_d, dd], dim=1)
    alli = torch.cat([main_i, di.to(main_i.dtype)], dim=1)
    dead = tombstone[torch.clamp(alli, 0, tombstone.shape[0] - 1).long()] \
        | (alli < 0)
    alld = torch.where(dead, float("inf"), alld)
    return merge_candidate_topk(alld, alli, k)


@dataclasses.dataclass
class FreshIndex:
    main: IVFIndex
    capacity: int                    # delta-buffer slots
    n_total: int                     # id space size of the main index
    delta_vecs: torch.Tensor = None  # (capacity, D) f32
    delta_ids: torch.Tensor = None   # (capacity,) int32, -1 = empty
    tombstone: torch.Tensor = None   # (n_total + capacity,) bool
    fill: int = 0
    next_id: int = 0

    def __post_init__(self):
        dev, d = self.main.device, self.main.dim
        if self.delta_vecs is None:
            self.delta_vecs = torch.zeros((self.capacity, d),
                                          dtype=torch.float32, device=dev)
        if self.delta_ids is None:
            self.delta_ids = torch.full((self.capacity,), -1,
                                        dtype=torch.int32, device=dev)
        if self.tombstone is None:
            self.tombstone = torch.zeros((self.n_total + self.capacity,),
                                         dtype=torch.bool, device=dev)
        self.next_id = max(self.next_id, self.n_total)

    # -- updates (host bookkeeping; the buffers are written in place) ------
    def insert(self, vecs: np.ndarray) -> np.ndarray:
        """Append vectors to the delta buffer; returns their new ids.
        Raises BufferError when the buffer is full: a rebuild is due."""
        n = vecs.shape[0]
        if self.fill + n > self.capacity:
            raise BufferError(
                f"delta buffer full ({self.fill}+{n}>{self.capacity}): "
                f"rebuild due")
        ids = np.arange(self.next_id, self.next_id + n, dtype=np.int32)
        dev = self.delta_vecs.device
        self.delta_vecs[self.fill:self.fill + n] = torch.from_numpy(
            np.asarray(vecs, np.float32)).to(dev)
        self.delta_ids[self.fill:self.fill + n] = torch.from_numpy(ids).to(
            dev)
        self.fill += n
        self.next_id += n
        return ids

    def delete(self, ids: np.ndarray) -> None:
        idx = torch.from_numpy(np.asarray(ids, np.int64)).to(
            self.tombstone.device)
        self.tombstone[idx] = True

    # -- search ------------------------------------------------------------
    def search(self, queries: torch.Tensor, k: int, nprobe: int):
        """Merged search: main IVF + delta brute force, tombstones
        filtered; (dists (B, k), ids (B, k))."""
        d_main, i_main = search_flat(self.main, queries, k, nprobe)
        return merge_fresh(d_main, i_main, queries, self.delta_vecs,
                           self.delta_ids, self.tombstone, k)

    def search_leveled(self, llsp_params, queries, k: int, cfg,
                       pad: int = 64):
        """The production merged path: main candidates through
        ``serve_leveled``, then the same merge as :meth:`search`.  Returns
        numpy (dists (B, k), ids (B, k))."""
        from .search import serve_leveled

        out = serve_leveled(self.main, llsp_params, queries,
                            np.full((len(queries),), k, np.int32), cfg,
                            pad=pad)
        dev = self.main.device
        d, i = merge_fresh(
            torch.from_numpy(out["dists"]).to(dev),
            torch.from_numpy(out["ids"]).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                queries, np.float32)).to(dev),
            self.delta_vecs, self.delta_ids, self.tombstone, k)
        return d.cpu().numpy(), i.cpu().numpy()

    # -- rebuild: fold the delta, drop tombstones --------------------------
    def fold_corpus(self, x_main: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """The rebuild corpus: live main vectors + live delta, with their
        ids in the old id space."""
        tomb = self.tombstone.cpu().numpy()
        live_main = np.nonzero(~tomb[: self.n_total])[0]
        dv = self.delta_vecs.cpu().numpy()[: self.fill]
        di = self.delta_ids.cpu().numpy()[: self.fill]
        live_delta = ~tomb[di]
        vecs = np.concatenate([x_main[live_main], dv[live_delta]])
        ids = np.concatenate([live_main, di[live_delta]])
        return vecs.astype(np.float32), ids.astype(np.int32)


def rebuild(fresh: FreshIndex, x_main: np.ndarray, build_cfg, workdir: str):
    """Daily-rebuild flow: fold, rebuild with the 3-stage pipeline on the
    main index's device, swap.  Returns (new FreshIndex over a compacted id
    space, old ids of its rows, its vectors)."""
    from repro_torch.build.pipeline import build_index

    vecs, old_ids = fresh.fold_corpus(x_main)
    index, _, _ = build_index(vecs, build_cfg, workdir,
                              device=fresh.main.device)
    new = FreshIndex(main=index, capacity=fresh.capacity,
                     n_total=vecs.shape[0])
    return new, old_ids, vecs
