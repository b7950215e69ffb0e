"""K-Means partition initialization (paper §3.1 step 1); counterpart of
``repro/core/kmeans.py``.

Distances use the ||x||² - 2x·c + ||c||² expansion so the inner loop is a
matmul. ``lloyd`` takes its initial centroids as an argument, so a test can
start the port and the JAX reference from the same centroids.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_ASSIGN_BLOCK = 65536  # rows per assignment block: bounds the [rows, B] matrix


class KMeansState(NamedTuple):
    centroids: torch.Tensor  # [B, d] f32
    assign: torch.Tensor     # [N] int32
    inertia: torch.Tensor    # [] f32 (sum of squared distances to assigned centroid)


def plus_plus_init(x: torch.Tensor, n_clusters: int,
                   generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (D² sampling), O(B·N·d). ``generator`` lives on x's
    device; the picks stay on the device (no host sync per centroid)."""
    n = x.shape[0]
    k0 = torch.randint(n, (1,), generator=generator, device=x.device)
    first = x[k0[0]]
    cents = torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = first
    d2 = ((x - first) ** 2).sum(-1)
    for i in range(1, n_clusters):
        probs = d2 / d2.sum().clamp_min(1e-12)
        idx = torch.multinomial(probs, 1, generator=generator)
        new_c = x[idx[0]]
        cents[i] = new_c
        d2 = torch.minimum(d2, ((x - new_c) ** 2).sum(-1))
    return cents


def assign_points(x: torch.Tensor, centroids: torch.Tensor):
    """(assignment [N] int32, sq-distance-to-assigned [N] f32): a matmul plus
    argmin, in row blocks. ``argmin`` returns the first minimum, as JAX's."""
    assign = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    dmin = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    c2 = (centroids * centroids).sum(-1)[None, :]
    for s in range(0, x.shape[0], _ASSIGN_BLOCK):
        xb = x[s:s + _ASSIGN_BLOCK]
        d2 = (xb * xb).sum(-1, keepdim=True) - 2.0 * xb @ centroids.T + c2
        a = torch.argmin(d2, dim=-1)
        assign[s:s + _ASSIGN_BLOCK] = a.to(torch.int32)
        dmin[s:s + _ASSIGN_BLOCK] = torch.gather(d2, 1, a[:, None])[:, 0]
    return assign, dmin


def lloyd(x: torch.Tensor, centroids: torch.Tensor, n_iters: int) -> KMeansState:
    """Lloyd's iterations from the given centroids; empty clusters keep their
    old centroid."""
    x = x.float()
    cents = centroids.float().clone()
    n_clusters = cents.shape[0]
    for _ in range(n_iters):
        assign, _ = assign_points(x, cents)
        a = assign.long()
        sums = torch.zeros_like(cents).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=n_clusters).float()
        cents = torch.where(counts[:, None] > 0,
                            sums / counts.clamp_min(1.0)[:, None], cents)
    assign, d2 = assign_points(x, cents)
    return KMeansState(centroids=cents, assign=assign, inertia=d2.sum())


def kmeans_fit(x: torch.Tensor, n_clusters: int, n_iters: int = 25, *,
               generator: torch.Generator) -> KMeansState:
    """k-means++ seeding then Lloyd. x: [N, d] on the device of ``generator``."""
    x = x.float()
    return lloyd(x, plus_plus_init(x, n_clusters, generator), n_iters)


def centroid_distances(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Query→centroid squared L2 distances `I` (probing-model input). [Q, B]."""
    return ((q * q).sum(-1, keepdim=True)
            - 2.0 * q @ centroids.T
            + (centroids * centroids).sum(-1)[None, :])
