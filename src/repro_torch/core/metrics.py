"""Paper metrics (§4.1): Recall@k, cmp (visited points), nprobe — a numpy
copy of ``repro/core/metrics.py``."""
from __future__ import annotations

import numpy as np


def recall_at_k(retrieved: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Paper eq. 1. retrieved/gt: [Q, >=k] id arrays."""
    hits = 0
    for r in range(len(gt)):
        hits += len(set(retrieved[r, :k].tolist()) & set(gt[r, :k].tolist()))
    return hits / (len(gt) * k)


def summarize(name: str, res) -> dict:
    """One row of a results table from a ``retrieval.SearchResult``."""
    return {
        "method": name,
        "recall": round(res.recall, 4),
        "cmp": round(res.cmp_mean, 1),
        "nprobe": round(res.nprobe_mean, 4),
    }


def pareto_frontier(points: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """(cost, recall) pareto frontier: min cost for any recall level."""
    pts = sorted(points)
    front, best = [], -np.inf
    for c, r in pts:
        if r > best:
            front.append((c, r))
            best = r
    return front


def cost_at_recall(curve: list[tuple[float, float]], target: float):
    """Min cost achieving recall >= target along a swept (cost, recall) curve.
    Returns (cost, recall) or None."""
    feas = [(c, r) for c, r in curve if r >= target]
    if not feas:
        return None
    return min(feas)
