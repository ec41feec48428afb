"""Per-query recall proxy of the q8 serving path (copy of ``recall_proxy``
from ``repro.obs.quality``)."""
from __future__ import annotations

import numpy as np


def recall_proxy(pre_ids: np.ndarray, post_ids: np.ndarray,
                 k: int) -> np.ndarray:
    """Row-wise overlap |pre ∩ post| / k between two (B, >=k) id arrays.
    Negative ids are padding and never match.  Returns (B,) float32."""
    pre = np.asarray(pre_ids)[:, :k]
    post = np.asarray(post_ids)[:, :k]
    hit = (pre[:, :, None] == post[:, None, :]) & (pre[:, :, None] >= 0)
    return hit.any(axis=2).sum(axis=1).astype(np.float32) / float(max(k, 1))
