"""What the q8 scan kernel shares with the f32 scan (port of the helpers in
``repro.kernels.ivf_scan``): the deduped probe plan and the top-k2 merge
rule.  The f32 kernel ``ivf_scan_topk`` itself is ported in a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.distance import INF


def plan_tile_probes(cids: torch.Tensor, mask: torch.Tensor, bq: int,
                     n_clusters: int, *, tile_chunk: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile block table + query-selection mask (plain device code).

    Flattens each tile of ``bq`` queries' (bq, P) probe list to S = bq*P
    slots, sorts by cluster id (dead probes sort to the end) and keeps only
    the first occurrence of each cluster live.  Returns

      tile_cids (B/bq, S) int32 — sorted cluster per slot,
      qsel      (B/bq, S, bq) int32 — nonzero iff query j of the tile probes
                tile_cids[t, s] and s is that cluster's first slot.

    A (query, cluster) pair probed more than once is scanned once.  Tiles are
    processed in chunks that bound the (c, S, bq, P) membership intermediate;
    the plan is bit-identical for any chunk size.
    """
    b, p = cids.shape
    nb = b // bq
    s_len = bq * p
    cl = torch.clamp(cids, 0, n_clusters - 1).to(torch.int32)
    live = mask.bool() & (cids >= 0)
    key = torch.where(live, cl, n_clusters).reshape(nb, s_len)
    sc = torch.sort(key, dim=1).values
    uniq = torch.cat([torch.ones((nb, 1), dtype=torch.bool, device=sc.device),
                      sc[:, 1:] != sc[:, :-1]], dim=1) & (sc < n_clusters)
    cl3 = cl.reshape(nb, bq, p)
    lv3 = live.reshape(nb, bq, p)
    if tile_chunk <= 0:
        tile_chunk = max(1, (1 << 24) // max(s_len * bq * p, 1))
    chunks = []
    for lo in range(0, nb, tile_chunk):
        hi = min(lo + tile_chunk, nb)
        member = torch.any(
            (cl3[lo:hi, None, :, :] == sc[lo:hi, :, None, None])
            & lv3[lo:hi, None, :, :], dim=-1)                  # (c, S, bq)
        chunks.append((member & uniq[lo:hi, :, None]).to(torch.int32))
    qsel = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
    tile_cids = torch.clamp_max(sc, n_clusters - 1).to(torch.int32)
    return tile_cids, qsel


def extract_topk(cat_d: torch.Tensor, cat_i: torch.Tensor, k2: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """k2-pass min extraction with duplicate-id suppression (the merge rule
    of the scan kernels).  cat_d, cat_i: (bq, n).  Each pass emits the
    global minimum (lowest column among equal values) and kills every
    remaining entry with the same id, so the output is ascending and unique
    by id with the per-id minimum; exhausted slots are (+inf, -1)."""
    bq, n = cat_d.shape
    if n == 0:
        return (cat_d.new_full((bq, k2), INF),
                torch.full((bq, k2), -1, dtype=torch.int32,
                           device=cat_d.device))
    col = torch.arange(n, device=cat_d.device).expand(bq, n)
    cat_i = cat_i.to(torch.int64)
    out_d, out_i = [], []
    for _ in range(k2):
        m = torch.min(cat_d, dim=1, keepdim=True).values
        pos = torch.min(torch.where(cat_d == m, col, n), dim=1,
                        keepdim=True).values
        hit = col == pos
        pid = torch.sum(torch.where(hit, cat_i, 0), dim=1, keepdim=True)
        ok = torch.isfinite(m)
        out_d.append(torch.where(ok, m, INF)[:, 0])
        out_i.append(torch.where(ok, pid, -1)[:, 0])
        kill = hit | ((cat_i == pid) & (pid >= 0) & ok)
        cat_d = torch.where(kill, INF, cat_d)
    return (torch.stack(out_d, dim=1),
            torch.stack(out_i, dim=1).to(torch.int32))
