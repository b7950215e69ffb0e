"""Learning-based redundancy (paper §3.3); counterpart of
``repro/core/redundancy.py``.

  PICK:      points whose own predicted nprobe (Σ 1[p̂_b > σ]) is in the top-η
             percentile are likely long-tail/boundary points.
  DUPLICATE: a picked point v is copied into the highest-p̂ partition that does
             not already hold v.

The pick is the reference's numpy ``argpartition`` on the predicted nprobe,
unchanged, so the same ``pred_nprobe`` gives the same picks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.kmeans import centroid_distances


class RedundancyPlan(NamedTuple):
    picked: np.ndarray        # [P] indices of duplicated points
    targets: np.ndarray       # [P, R] partition id(s) each replica goes to
    pred_nprobe: np.ndarray   # [N] predicted nprobe of every point


@torch.no_grad()
def plan_redundancy(model, x, assign, centroids, *, eta: float, sigma: float = 0.5,
                    max_replicas: int = 1, batch: int = 8192) -> RedundancyPlan:
    """Runs the probing model over all data points (blocked, on the model's
    device) and picks/places."""
    device = next(model.parameters()).device
    cents = torch.as_tensor(centroids, dtype=torch.float32, device=device)
    n = len(x)
    pred, tops = [], []
    for s in range(0, n, batch):
        xb = torch.as_tensor(x[s:s + batch], dtype=torch.float32, device=device)
        p = model.probs(xb, centroid_distances(xb, cents))
        pred.append((p > sigma).sum(-1).to(torch.int32))
        # +1 slot so we can skip the point's own partition; a stable
        # descending sort keeps jax.lax.top_k's lowest-index-first ties
        tops.append(torch.sort(p, dim=-1, descending=True, stable=True)[1]
                    [:, :max_replicas + 1].to(torch.int32))
    pred_np = torch.cat(pred).cpu().numpy()
    top_parts = torch.cat(tops).cpu().numpy()

    n_pick = int(round(n * eta))
    if n_pick == 0:
        return RedundancyPlan(np.empty(0, np.int64), np.empty((0, max_replicas), np.int32), pred_np)
    # top-η percentile of predicted nprobe (ties broken arbitrarily)
    picked = np.argpartition(-pred_np, n_pick - 1)[:n_pick]

    # target = highest-p̂ partition that is not the point's home partition
    tp = top_parts[picked]                                       # [P, R+1]
    home = np.asarray(torch.as_tensor(assign).cpu())[picked]     # [P]
    targets = np.empty((n_pick, max_replicas), np.int32)
    for r in range(max_replicas):
        cand = tp[:, r]
        targets[:, r] = np.where(cand == home, tp[:, r + 1], cand)
    return RedundancyPlan(picked=picked, targets=targets, pred_nprobe=pred_np)


def replica_rows(plan: RedundancyPlan, x, ids):
    """Replica (vectors, ids, assigns) for ``partitions.build_store``'s
    ``extra``; vectors follow x's type (array or tensor)."""
    if len(plan.picked) == 0:
        return (np.empty((0, x.shape[1]), np.float32), np.empty(0, np.int32),
                np.empty(0, np.int32))
    picked = plan.picked
    if isinstance(x, torch.Tensor):
        picked = torch.as_tensor(picked, device=x.device)
    reps_v, reps_i, reps_a = [], [], []
    for r in range(plan.targets.shape[1]):
        reps_v.append(x[picked])
        reps_i.append(np.asarray(ids)[plan.picked])
        reps_a.append(plan.targets[:, r])
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    return (cat(reps_v, 0),
            np.concatenate(reps_i, 0).astype(np.int32),
            np.concatenate(reps_a, 0).astype(np.int32))
