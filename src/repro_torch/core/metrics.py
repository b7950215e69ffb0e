"""Paper metrics (§4.1) — a numpy copy of ``repro/core/metrics.py:recall_at_k``."""
from __future__ import annotations

import numpy as np


def recall_at_k(retrieved: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Paper eq. 1. retrieved/gt: [Q, >=k] id arrays."""
    hits = 0
    for r in range(len(gt)):
        hits += len(set(retrieved[r, :k].tolist()) & set(gt[r, :k].tolist()))
    return hits / (len(gt) * k)
