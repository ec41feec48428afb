"""EmbeddingBag over model-sharded tables, the recsys hot path (port of
``repro.models.recsys.embedding``).

Layout: ids come as a fixed-shape matrix (B, S) (S = multi-hot slots per
bag; id < 0 = empty slot).  The bag is the row: lookup + pooling is a
gather of the (B*S,) clipped ids, masked, then a sum over each row's S
slots (the reference's ``take`` + ``segment_sum`` over
``repeat(arange(B), S)``, whose segments are those contiguous runs).

The gather is ``torch.nn.functional.embedding``: its backward on the card
sums each row's repeated ids in a fixed order (sort, then a segmented
reduction), so two identical training steps give the same bits, which a
bit-exact resume needs.  ``index_select`` (and ``index_add_``) sum
repeated ids with atomics, in an order that varies from run to run, and
Zipf ids repeat hot rows in every batch.

* :func:`embedding_bag`, :func:`embedding_lookup`: one device.
* :func:`embedding_bag_sharded`, :func:`embedding_lookup_sharded`: the
  table is ROW-sharded over the ``model`` axis of a
  :class:`repro_torch.launch.mesh.Mesh`.  Each rank holds its row block
  (``distributed/sharding.py`` ``recsys_table_spec``) and its block of the
  batch, masks the ids to its rows, gathers locally (other ids contribute
  zero), and the result is summed over ``model``
  (``distributed/collectives.py`` ``all_reduce``): the communication is
  the pooled (B, D) output, not the table.  Forward only: the reduction
  is not differentiable here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids already clipped to ``[0, rows)``, with a
    deterministic backward on the card."""
    return F.embedding(ids.long(), table)


def embedding_bag(
    table: torch.Tensor,                       # (R, D)
    ids: torch.Tensor,                         # (B, S) int32; < 0 empty
    weights: Optional[torch.Tensor] = None,    # (B, S)
) -> torch.Tensor:
    """Pooled (B, D) embeddings: gather + a sum over each row's bag."""
    b, s = ids.shape
    flat = ids.reshape(-1)
    vecs = gather_rows(table, torch.clamp(flat, 0, table.shape[0] - 1))
    if weights is not None:
        vecs = vecs * weights.reshape(-1, 1)
    vecs = torch.where((flat >= 0)[:, None], vecs, 0.0)
    return vecs.reshape(b, s, -1).sum(dim=1)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor
                     ) -> torch.Tensor:
    """Unpooled (B, S, D) lookup (DIN/MIND need per-position vectors)."""
    vecs = gather_rows(table, torch.clamp(ids, 0, table.shape[0] - 1))
    return torch.where((ids >= 0)[..., None], vecs, 0.0)


def _local_rows(table_l: torch.Tensor, ids: torch.Tensor, mesh
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the ids relative to this rank's row block, clipped into it; the
    mask of the ids the block holds)."""
    r_loc = table_l.shape[0]
    lo = mesh.index("model") * r_loc
    rel = ids - lo
    mine = (rel >= 0) & (rel < r_loc) & (ids >= 0)
    return torch.clamp(rel, 0, r_loc - 1), mine


def embedding_bag_sharded(
    table: torch.Tensor,       # this rank's (R / model, D) row block
    ids: torch.Tensor,         # this rank's (B_loc, S) batch block
    mesh,
    weights: Optional[torch.Tensor] = None,
    batch_axes: tuple = ("data",),
) -> torch.Tensor:
    """Row-sharded EmbeddingBag: local gather + bag sum, summed over
    ``model``; this rank's (B_loc, D).  ``batch_axes`` names the axes the
    batch is split over (the ids arrive already cut to this rank's
    block)."""
    from repro_torch.distributed.collectives import all_reduce

    b, s = ids.shape
    flat = ids.reshape(-1)
    rel, mine = _local_rows(table, flat, mesh)
    vecs = gather_rows(table, rel)
    if weights is not None:
        vecs = vecs * weights.reshape(-1, 1)
    vecs = torch.where(mine[:, None], vecs, 0.0)
    pooled = vecs.reshape(b, s, -1).sum(dim=1)
    return all_reduce(pooled, mesh.group("model"))


def embedding_lookup_sharded(
    table: torch.Tensor,       # this rank's (R / model, D) row block
    ids: torch.Tensor,         # this rank's (B_loc, S) batch block
    mesh,
    batch_axes: tuple = ("data",),
) -> torch.Tensor:
    """Unpooled sharded lookup, this rank's (B_loc, S, D), equal bit for
    bit to :func:`embedding_lookup` of the whole table: one rank holds each
    id's row and the others add -0.0, the additive identity (``x + -0.0 ==
    x`` for every x, +0.0 and -0.0 included, where +0.0 would turn a -0.0
    entry into +0.0); an empty slot (id < 0) is +0.0 from shard 0."""
    from repro_torch.distributed.collectives import all_reduce

    rel, mine = _local_rows(table, ids, mesh)
    empty = 0.0 if mesh.index("model") == 0 else -0.0
    fill = torch.where(ids < 0, empty, -0.0)[..., None]
    vecs = torch.where(mine[..., None], gather_rows(table, rel), fill)
    return all_reduce(vecs, mesh.group("model"))
