"""Exact kNN ground truth and kNN partition distributions (paper §2.1);
counterpart of ``repro/core/ground_truth.py``. ``exact_knn`` is batched brute
force on the device, used for evaluation and for the probing-model labels on
a training subset; the distributions are numpy on the host, as in the
reference."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import input_device


def _smallest_k_sorted(d2: torch.Tensor, k: int):
    """k smallest per row, ascending; equal distances in index order (the
    order ``jax.lax.top_k`` gives; ``torch.topk`` promises none)."""
    vals, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    idx, o = torch.sort(idx, dim=1)
    vals = torch.gather(vals, 1, o)
    vals, o = torch.sort(vals, dim=1, stable=True)
    return vals, torch.gather(idx, 1, o)


def exact_knn(queries, base, k: int, *, batch: int = 1024,
              exclude_self: bool = False, device=None):
    """Exact kNN of ``queries`` in ``base``: (dists [Q,k], ids [Q,k]) as numpy.

    Inputs are arrays or tensors; the work runs on ``device`` (default: the
    device of ``base`` or ``queries`` when one is a tensor, else the card,
    raising when there is none). If exclude_self,
    asks for k+1 and drops exact self-matches (training labels where queries
    ⊆ base): per row, the first k columns whose distance is > 1e-9, or
    columns 1..k when fewer than k qualify — the reference's choice.
    """
    device = input_device(device, base, queries)
    kk = k + 1 if exclude_self else k
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    b = torch.as_tensor(base, dtype=torch.float32, device=device)
    b2 = (b * b).sum(-1)[None, :]
    out_d, out_i = [], []
    for s in range(0, q.shape[0], batch):
        qb = q[s:s + batch]
        d2 = (qb * qb).sum(-1, keepdim=True) - 2.0 * qb @ b.T + b2
        d, i = _smallest_k_sorted(d2, kk)
        out_d.append(d.cpu().numpy())
        out_i.append(i.to(torch.int32).cpu().numpy())
    dists, ids = np.concatenate(out_d), np.concatenate(out_i)
    return drop_self(dists, ids, k) if exclude_self else (dists, ids)


def drop_self(dists: np.ndarray, ids: np.ndarray, k: int):
    """From [Q, k+1] neighbours, keep per row the first k columns whose
    distance is > 1e-9, or columns 1..k when fewer than k qualify — the
    reference's per-row choice, vectorized. (Which self-matches fall under
    1e-9 depends on the rounding of the L2 expansion.)"""
    ok = dists > 1e-9
    # first k qualifying columns, in column order (stable sort puts them first)
    cols = np.argsort(~ok, axis=1, kind="stable")[:, :k]
    cols[ok.sum(1) < k] = np.arange(1, k + 1)  # degenerate duplicates
    return (np.take_along_axis(dists, cols, 1).astype(np.float32),
            np.take_along_axis(ids, cols, 1).astype(np.int32))


def knn_count_distribution(gt_ids: np.ndarray, assign: np.ndarray, n_partitions: int) -> np.ndarray:
    """n^q (paper def. 1): per-query count of GT kNN in each partition. [Q, B]."""
    part = assign[gt_ids]  # [Q, k]
    out = np.zeros((gt_ids.shape[0], n_partitions), np.int32)
    rows = np.repeat(np.arange(gt_ids.shape[0]), gt_ids.shape[1])
    np.add.at(out, (rows, part.reshape(-1)), 1)
    return out


def knn_partition_labels(gt_ids: np.ndarray, assign: np.ndarray, n_partitions: int) -> np.ndarray:
    """p^q: binary mask over partitions that contain ≥1 true kNN. [Q, B] f32."""
    return (knn_count_distribution(gt_ids, assign, n_partitions) > 0).astype(np.float32)


def optimal_nprobe(labels: np.ndarray) -> np.ndarray:
    """(nprobe^q)* = number of kNN partitions."""
    return labels.sum(-1).astype(np.int32)


def nprobe_dist(gt_ids: np.ndarray, assign: np.ndarray, q: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """nprobe*_dist (paper §2.2): max centroid-distance-rank over kNN partitions —
    how many nearest-centroid probes IVF needs to cover all kNN."""
    d2 = (
        np.sum(q * q, -1, keepdims=True)
        - 2.0 * q @ centroids.T
        + np.sum(centroids * centroids, -1)[None, :]
    )
    rank = np.argsort(np.argsort(d2, -1), -1)  # rank of each partition per query
    part = assign[gt_ids]  # [Q, k]
    return rank[np.arange(len(q))[:, None], part].max(1).astype(np.int32) + 1
