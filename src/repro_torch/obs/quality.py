"""Online quality observability: per-query recall proxies + shadow audits.

Latency observability (``obs.trace``) answers "where did this query spend its
time?"; this module answers the operator's harder question — "is recall
degrading RIGHT NOW, and where?" — without an offline bench run:

* **recall proxy** — on the q8 serving default every harvested
  batch already exact-rescores its fused-topk candidates at f32, so the
  overlap between the pre-rerank approximate top-k and the post-rerank
  exact top-k is a FREE per-query quality signal (FusionANNS 2409.16576
  uses the same agreement as its stopping rule).  The fabric stamps a
  coverage proxy instead: the fraction of a query's probed clusters that
  a live replica actually scanned (1.0 on complete rows, < 1.0 on
  ``partial`` rows — exactly the rows whose recall is at risk).
* **shadow audit lane** — proxies need calibration, and f32/no-rerank
  paths have no rerank to disagree with.  A deterministic Knuth-hash
  sample of queries (default ~1%) is brute-force rescanned against the
  live corpus snapshot on a dedicated single-lane executor, producing a
  measured true recall and a per-audit ``|proxy - true|`` calibration
  error.  Submission never blocks serving: the audit queue is bounded and
  overflow audits are dropped (counted, never silent).

Streams (all bounded-memory, via :mod:`repro_torch.obs.metrics`):

=============================  ========================================
``quality.recall_proxy``        histogram of per-query proxies, plus
``quality.recall_proxy.<lab>``  labeled variants by route / nprobe
                                bucket / degrade status / shard
``quality.recall_true``         shadow-audited true recall
``quality.calibration_err``     per-audit ``|proxy - true|``
``quality.queries``             counter (labels: route, status)
``quality.low_proxy``           queries with proxy < ``low_threshold``
                                — the "bad event" stream the SLO burn
                                tracker consumes
``quality.audits``              counter (labels: done, dropped)
=============================  ========================================
"""
from __future__ import annotations

import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .trace import _KNUTH, _MASK32

# histogram domain for recall-like values in [0, 1]: lo=1e-3 keeps the
# relative-error contract for small proxies, hi just above 1.0 so exact
# agreement (proxy == 1.0) lands in the top bucket instead of overflow
_Q_LO, _Q_HI = 1e-3, 1.0 + 1e-9


def shadow_sampled(req_id: int, rate: float) -> bool:
    """Deterministic shadow-audit decision: Knuth-hash the request id to
    [0, 1) — the same idiom trace sampling uses, so a given rate audits
    the same requests on every replay of a seeded trace.  Keyed on
    ``req_id`` (not trace_id, which is 0 for unsampled requests)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return ((int(req_id) * _KNUTH) & _MASK32) / 4294967296.0 < rate


def recall_proxy(pre_ids: np.ndarray, post_ids: np.ndarray,
                 k: int) -> np.ndarray:
    """Row-wise overlap |pre ∩ post| / k between two (B, >=k) id arrays.
    Negative ids are padding and never match.  Returns (B,) float32."""
    pre = np.asarray(pre_ids)[:, :k]
    post = np.asarray(post_ids)[:, :k]
    hit = (pre[:, :, None] == post[:, None, :]) & (pre[:, :, None] >= 0)
    return hit.any(axis=2).sum(axis=1).astype(np.float32) / float(max(k, 1))


def overlap_frac(ids: np.ndarray, true_ids: np.ndarray, k: int) -> float:
    """Scalar recall of one answer row against brute-force ground truth."""
    a = np.asarray(ids).ravel()[:k]
    b = set(int(i) for i in np.asarray(true_ids).ravel()[:k])
    return sum(1 for i in a if int(i) >= 0 and int(i) in b) / max(k, 1)


_NP_CACHE: dict = {}


def _nprobe_bucket(nprobe: int) -> str:
    """Coarse power-of-two bucket so labels stay bounded."""
    n = max(int(nprobe), 1)
    lab = _NP_CACHE.get(n)
    if lab is None:
        b = 1
        while b < n:
            b <<= 1
        lab = _NP_CACHE[n] = f"np{b}"
    return lab


class QualityMonitor:
    """Per-query quality streams + the shadow audit lane (see module doc).

    One monitor per serving stack; the engine calls :meth:`observe_batch`
    once per harvested batch from the completion funnel.  ``vectors`` is
    the ground-truth corpus for shadow audits — an (N, D) float array or
    a zero-arg callable returning one (so lifecycle swaps can hand the
    auditor the LIVE snapshot); ``None`` disables auditing but keeps the
    proxy streams.
    """

    def __init__(self, metrics, *, vectors=None, shadow_rate: float = 0.01,
                 low_threshold: float = 0.9, harvest=None, trace=None,
                 max_pending: int = 256):
        self.metrics = metrics
        self._vec_fn = (vectors if callable(vectors)
                        else (lambda: vectors)) if vectors is not None \
            else None
        self.shadow_rate = float(shadow_rate)
        self.low_threshold = float(low_threshold)
        self.harvest = harvest
        self.trace = trace
        self.max_pending = int(max_pending)
        self._lock = threading.Lock()
        self._exec: Optional[ThreadPoolExecutor] = None
        self._futures: set = set()
        self._hcache: dict = {}       # label -> Histogram, hot-path lookup
        self._corpus_cache = None     # (vectors_obj, f32 view, |v|^2)
        self.proxy_hist = metrics.histogram(
            "quality.recall_proxy", lo=_Q_LO, hi=_Q_HI)
        self.true_hist = metrics.histogram(
            "quality.recall_true", lo=_Q_LO, hi=_Q_HI)
        self.calib_hist = metrics.histogram(
            "quality.calibration_err", lo=1e-4, hi=_Q_HI)
        self.queries = metrics.counter("quality.queries")
        self.low_proxy = metrics.counter("quality.low_proxy")
        self.audits = metrics.counter("quality.audits")
        self.not_ok = metrics.counter("quality.not_ok")

    # -- proxy streaming ---------------------------------------------------
    def _labeled_hist(self, label: str):
        h = self._hcache.get(label)
        if h is None:
            h = self.metrics.histogram(
                f"quality.recall_proxy.{label}", lo=_Q_LO, hi=_Q_HI)
            self._hcache[label] = h
        return h

    def observe_batch(self, requests, comps, *, shards=None,
                      rerank_rounds: int = 0) -> None:
        """Fold one harvested batch into the quality streams.

        ``requests[i]`` pairs with ``comps[i]``; each completion carries
        its per-query proxy in ``comp.quality`` (-1 = the serving path
        produced no proxy — pure f32, no rerank) and its nprobe;
        ``shards`` is the fabric's per-query primary shard array (or None
        single-node).  Never blocks: shadow audits go to the bounded
        executor queue.
        """
        n_low = 0
        n_routed = n_direct = 0
        proxies: list = []
        groups: dict = {}          # label -> proxy values, flushed batched
        recs: Optional[list] = [] if self.harvest is not None else None
        rr = int(rerank_rounds)
        low = self.low_threshold
        for i, (req, comp) in enumerate(zip(requests, comps)):
            if getattr(req, "route", None) is not None:
                rlab, route = "route:routed", "routed"
                n_routed += 1
            else:
                rlab, route = "route:direct", "direct"
                n_direct += 1
            status = comp.status
            if status != "ok":
                self.not_ok.inc(1.0, label=status)
            q = getattr(comp, "quality", None)
            proxy = None
            if q is not None:
                qv = float(q)
                if qv >= 0.0 and math.isfinite(qv):
                    proxy = qv
            if proxy is not None:
                proxies.append(proxy)
                groups.setdefault(rlab, []).append(proxy)
                groups.setdefault(
                    _nprobe_bucket(comp.nprobe), []).append(proxy)
                if status != "ok":
                    groups.setdefault(f"status:{status}", []).append(proxy)
                if shards is not None:
                    groups.setdefault(
                        f"shard:{int(shards[i])}", []).append(proxy)
                if proxy < low:
                    n_low += 1
            self._maybe_shadow(req, comp, proxy)
            if recs is not None:
                done, sub = float(comp.completed), float(comp.submitted)
                recs.append((
                    int(getattr(req, "req_id", -1)),
                    getattr(req, "index", "") or "",
                    int(getattr(req, "trace_id", 0)),
                    done, route, int(comp.nprobe),
                    status, comp.reason or "",
                    done - sub if done > sub else 0.0,
                    rr,
                    -1.0 if proxy is None else proxy,
                    -1 if shards is None else int(shards[i]),
                    self._clusters_of(req),
                ))
        if proxies:
            self.proxy_hist.observe_many(proxies)
            for lab, vals in groups.items():
                self._labeled_hist(lab).observe_many(vals)
        if recs:
            self.harvest.extend(recs)
        if n_routed:
            self.queries.inc(float(n_routed), label="route:routed")
        if n_direct:
            self.queries.inc(float(n_direct), label="route:direct")
        if n_low:
            self.low_proxy.inc(float(n_low))

    @staticmethod
    def _clusters_of(req):
        route = getattr(req, "route", None)
        cids = getattr(route, "cids", None) if route is not None else None
        if cids is None:
            return ()
        row = np.asarray(cids).ravel()
        return tuple(int(c) for c in row[row >= 0][:8])

    # -- shadow audit lane -------------------------------------------------
    def _maybe_shadow(self, req, comp, proxy) -> None:
        if self._vec_fn is None or self.shadow_rate <= 0.0:
            return
        if comp.status in ("shed", "failed") or comp.ids is None:
            return
        if not shadow_sampled(getattr(req, "req_id", 0), self.shadow_rate):
            return
        with self._lock:
            if len(self._futures) >= self.max_pending:
                self.audits.inc(1.0, label="dropped")
                return
            if self._exec is None:
                self._exec = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="shadow-audit")
            k = int(getattr(req, "topk", len(np.asarray(comp.ids).ravel())))
            fut = self._exec.submit(
                self._audit, np.array(req.query, np.float32, copy=True),
                np.array(comp.ids, copy=True), k, proxy)
            self._futures.add(fut)
        # registered OUTSIDE the lock: an already-finished future runs the
        # callback inline on THIS thread, and _done needs the lock
        fut.add_done_callback(self._done)

    def _done(self, fut) -> None:
        with self._lock:
            self._futures.discard(fut)

    def _corpus(self):
        """(vectors, |v|^2) with the norms cached across audits — keyed by
        object identity with the source pinned in the cache tuple, so a
        lifecycle swap (new snapshot object) recomputes and a static corpus
        pays the norm pass exactly once."""
        v = self._vec_fn()
        cached = self._corpus_cache
        if cached is None or cached[0] is not v:
            arr = np.asarray(v, np.float32)
            n2 = (arr.astype(np.float64) ** 2).sum(axis=1)
            self._corpus_cache = (v, arr, n2)
            return arr, n2
        return cached[1], cached[2]

    def _audit(self, query, ids, k, proxy) -> float:
        vectors, n2 = self._corpus()
        # |v - q|^2 = |v|^2 - 2 v.q + |q|^2; the constant |q|^2 term cannot
        # change the ranking, so one matvec replaces the (N, D) residual
        # materialization — the audit lane shares a single core with serving
        d = n2 - 2.0 * (vectors @ query).astype(np.float64)
        kk = min(k, d.shape[0])
        true_ids = np.argpartition(d, kk - 1)[:kk]
        true = overlap_frac(ids, true_ids, kk)
        self.true_hist.observe(true)
        if proxy is not None and np.isfinite(proxy):
            self.calib_hist.observe(abs(float(proxy) - true))
        self.audits.inc(1.0, label="done")
        return true

    @property
    def pending_audits(self) -> int:
        with self._lock:
            return len(self._futures)

    def drain(self, timeout_s: float = 10.0) -> None:
        """Block until in-flight audits complete (shutdown/bench only —
        the serving path never calls this)."""
        import time as _time
        t1 = _time.monotonic() + timeout_s
        while self.pending_audits and _time.monotonic() < t1:
            _time.sleep(0.002)

    def close(self) -> None:
        self.drain()
        with self._lock:
            ex, self._exec = self._exec, None
        if ex is not None:
            ex.shutdown(wait=True)

    # -- readout -----------------------------------------------------------
    def summary(self) -> dict:
        """JSON-able rollup for health snapshots."""
        n = self.proxy_hist.n
        return {
            "queries": self.queries.value(),
            "proxy": self.proxy_hist.to_dict(),
            "low_proxy": self.low_proxy.value(),
            "low_frac": self.low_proxy.value() / max(n, 1),
            "audits_done": self.audits.value("done"),
            "audits_dropped": self.audits.value("dropped"),
            "true": self.true_hist.to_dict(),
            "calibration_err": self.calib_hist.to_dict(),
        }
