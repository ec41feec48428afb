"""The comparison that decides ``correct``: what the timed path produced,
judged against :mod:`reference`, number by number against the cell's
limits.

Serving: for a sample of the window's requests, drawn from the seed, the
reference works out each query's plan again (the nearest centroids and
LLSP's probe count) and the answer its tier owes at the probe count the
request was served with.  ``dist_gap`` is the widest gap, over the sample
and the k ranks, by which the i-th nearest served id lies farther than the
reference's i-th, by exact L2 and relative to the reference's k-th
distance: 0 when the answers agree, about float32's rounding when a
near tie swaps, and far more when a neighbour is lost.  On the q8 tier a
query whose k2-th and (k2+1)-th code distances tie within 1e-5 has two
valid candidate sets; it is left out of the gap and counted in
``tie_skips``.  ``nprobe_flips`` holds LLSP's decision: the share of
sampled queries whose served probe count differs from the reference's.
Logged beside them: ``id_miss``, the mean share of the reference's ids
missing from the served answer.

Build: ``payload_err`` is the largest difference between a posting slot's
vector and the corpus row of its id (0: the payload is the corpus);
``missing_ids`` counts corpus rows held by no posting list;
``assign_miss`` is the share of rows held by another set of clusters than
the closure rule over the build's own centroids gives;
``over_bound`` is the share of clusters whose nearest-centroid cell holds
more vectors than the size bound.  ``distortion`` holds the centroids:
the corpus's mean squared L2 to its nearest centroid, which a build whose
k-means stopped at its initial centroids raises.  ``llsp_unfit`` holds
LLSP's training: over the logged queries it was trained on, the squared
error of the probe counts its trees give (descended by the reference)
against the reference's own labels (the fewest probes holding the recall
target), over the labels' variance: near 0 for trained trees, about 1 for
trees that only give the labels' mean.

A control (``tf32``, ``int4``) is the reference put in the program's
place in a lower precision; it is judged by the same functions.
"""
from __future__ import annotations

import torch

from . import reference as ref


def serve_outputs(q, x, idx: dict, trees: dict, cfg: dict, *,
                  precision: str = "f32", bits: int = 8,
                  nprobe=None):
    """(ids (S, k), nprobe (S,), tie (S,)) that the reference's own path
    serves for ``q``: its plan, then its tier's answer at ``nprobe`` if
    given, else at the plan's count; ``tie`` marks the queries whose answer
    the tier's rule leaves open (see ``reference.q8_rerank_topk``)."""
    s, llsp = cfg["serve"], cfg["llsp"]
    cids, nps = ref.plan(q, idx["centroids"], trees,
                         nprobe_max=s["nprobe_max"], n_ratio=llsp["n_ratio"],
                         topk=s["k"], precision=precision)
    use = nps if nprobe is None else nprobe
    if s["tier"] == "q8":
        quant = ref.quantize(x, idx["centroids"], idx["posting_ids"], bits)
        ids, tie = ref.q8_rerank_topk(q, x, idx["centroids"],
                                      idx["posting_ids"], quant, cids, use,
                                      s["k"], s["n_cand"])
    else:
        ids = ref.exact_topk(q, x, idx["posting_ids"], cids, use, s["k"],
                             precision=precision)
        tie = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    return ids, nps, tie


def serve_numbers(q, x, idx: dict, trees: dict, cfg: dict, got_ids,
                  got_nprobe) -> dict:
    """The serving numbers of answers ``got_ids`` (S, k) served with probe
    counts ``got_nprobe`` (S,) for queries ``q``."""
    want, ref_np, tie = serve_outputs(q, x, idx, trees, cfg,
                                      nprobe=got_nprobe.to(torch.int64))
    got = got_ids.to(torch.int64)
    hit = (want[:, :, None] == got[:, None, :]).any(-1) & (want >= 0)
    miss = 1.0 - hit.sum(1).double() / (want >= 0).sum(1).clamp_min(1)
    d_got, _ = torch.sort(_exact64(q, x, got), dim=1)
    d_want, _ = torch.sort(_exact64(q, x, want), dim=1)
    gap = (d_got - d_want) / d_want[:, -1:].clamp_min(1e-30)
    gap = torch.where(tie[:, None], 0.0, gap)
    return {"dist_gap": float(gap.max()),
            "nprobe_flips": float((ref_np != got_nprobe).double().mean()),
            "id_miss": float(miss.mean()),
            "tie_skips": float(tie.sum())}


def _exact64(q, x, ids):
    """(S, k) exact squared L2 in float64 of each query to its ids; +inf
    for an id outside the corpus (a missing answer)."""
    ok = (ids >= 0) & (ids < x.shape[0])
    rows = x[ids.clamp(0, x.shape[0] - 1)].double()
    d = ((rows - q.double()[:, None, :]) ** 2).sum(-1)
    return torch.where(ok, d, float("inf"))


def serve_control(q, x, idx: dict, trees: dict, cfg: dict, kind: str
                  ) -> dict:
    """The serving numbers of the control ``kind`` in the program's
    place."""
    kw = {"tf32": {"precision": "tf32"}, "int4": {"bits": 4}}[kind]
    ids, nps, _ = serve_outputs(q, x, idx, trees, cfg, **kw)
    return serve_numbers(q, x, idx, trees, cfg, ids, nps)


def build_numbers(x, idx: dict, cfg: dict, trees: dict, train_q) -> dict:
    """The build numbers of an index ``idx`` and LLSP ``trees`` built from
    corpus ``x`` and the logged queries ``train_q``."""
    b = cfg["build"]
    cents, pids = idx["centroids"], idx["posting_ids"].to(torch.int64)
    n = x.shape[0]
    live = pids >= 0
    err = (idx["postings"][live] - x[pids[live]]).abs()
    payload = float(err.max()) if err.numel() else 0.0
    held = torch.bincount(pids[live], minlength=n)[:n]
    want = ref.posting_ids(
        ref.closure(x, cents, eps=b["closure_eps"],
                    max_replicas=b["max_replicas"]),
        cents.shape[0], b["cluster_len"])
    width = b["max_replicas"]
    diff = (ref.membership(pids, n, width)
            != ref.membership(want, n, width)).any(1)
    over = ref.primary_counts(x, cents) > b["max_cluster_size"]
    return {"payload_err": payload,
            "missing_ids": float((held == 0).sum()),
            "assign_miss": float(diff.double().mean()),
            "over_bound": float(over.double().mean()),
            "distortion": ref.distortion(x, cents),
            "llsp_unfit": llsp_unfit(x, idx, trees, train_q, cfg)}


def llsp_unfit(x, idx: dict, trees: dict, train_q, cfg: dict) -> float:
    """Squared error of LLSP's probe counts for its training queries
    against the reference's labels, over the labels' variance."""
    s, llsp = cfg["serve"], cfg["llsp"]
    _, got = ref.plan(train_q, idx["centroids"], trees,
                      nprobe_max=s["nprobe_max"], n_ratio=llsp["n_ratio"],
                      topk=s["k"])
    want = ref.nprobe_labels(train_q, x, idx["centroids"],
                             idx["posting_ids"].to(torch.int64),
                             nprobe_max=s["nprobe_max"], k=s["k"],
                             target=llsp["recall_target"]).double()
    err = float(((got.double() - want) ** 2).sum())
    return err / max(float(((want - want.mean()) ** 2).sum()), 1e-12)


def build_control(x, idx: dict, cfg: dict, trees: dict, train_q) -> dict:
    """The build numbers of the closure assignment made in TF32 in the
    program's place, over the build's own centroids and LLSP."""
    b = cfg["build"]
    cents = idx["centroids"]
    pids = ref.posting_ids(
        ref.closure(x, cents, eps=b["closure_eps"],
                    max_replicas=b["max_replicas"], precision="tf32"),
        cents.shape[0], b["cluster_len"])
    post = x[pids.clamp_min(0)]
    return build_numbers(x, {"centroids": cents, "posting_ids": pids,
                             "postings": post}, cfg, trees, train_q)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: [number, limit]}).  Only the
    numbers the cell's limits name are judged; the rest are logged."""
    shown = {k: [numbers[k], limits[k]] for k in limits}
    return all(v <= lim for v, lim in shown.values()), shown
