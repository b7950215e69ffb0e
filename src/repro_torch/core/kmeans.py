"""K-Means partition initialization (paper §3.1 step 1); counterpart of
``repro/core/kmeans.py``.

Distances use the ||x||² - 2x·c + ||c||² expansion so the inner loop is a
matmul; with ``use_kernel`` the assignment pass is the fused kernel
(``kernels/kmeans_assign.py``) on the card. ``lloyd`` takes its initial
centroids as an argument, so a test can start the port and the JAX reference
from the same centroids.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops


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


def assign_points(x: torch.Tensor, centroids: torch.Tensor, *, use_kernel: bool = False):
    """(assignment [N] int32, sq-distance-to-assigned [N] f32). The plain
    matmul + argmin in row blocks (``argmin`` returns the first minimum, as
    JAX's), or with ``use_kernel`` the fused kernel wherever ``x`` lies on the
    card."""
    return kops.kmeans_assign(x, centroids, impl=None if use_kernel else "ref")


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Row sums of ``x`` [N, d] per segment id ``seg`` [N] int64 → [n, d],
    the same bits on every run: an accumulating ``index_put_`` under PyTorch's
    deterministic algorithms, which on CUDA sorts the ids and sums each
    segment in row order (``index_add_`` there adds by float atomics, in an
    order that changes from run to run). The switch is scoped to this call."""
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out.index_put_((seg,), x, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)
    return out


def lloyd(x: torch.Tensor, centroids: torch.Tensor, n_iters: int, *,
          use_kernel: bool = False) -> KMeansState:
    """Lloyd's iterations from the given centroids; empty clusters keep their
    old centroid. The same inputs give the same bits on every run."""
    x = x.float()
    cents = centroids.float().clone()
    n_clusters = cents.shape[0]
    for _ in range(n_iters):
        assign, _ = assign_points(x, cents, use_kernel=use_kernel)
        a = assign.long()
        sums = segment_sum(x, a, n_clusters)
        counts = torch.bincount(a, minlength=n_clusters).float()
        cents = torch.where(counts[:, None] > 0,
                            sums / counts.clamp_min(1.0)[:, None], cents)
    assign, d2 = assign_points(x, cents, use_kernel=use_kernel)
    return KMeansState(centroids=cents, assign=assign, inertia=d2.sum())


def kmeans_fit(x: torch.Tensor, n_clusters: int, n_iters: int = 25, *,
               generator: torch.Generator, use_kernel: bool = False) -> KMeansState:
    """k-means++ seeding then Lloyd. x: [N, d] on the device of ``generator``."""
    x = x.float()
    return lloyd(x, plus_plus_init(x, n_clusters, generator), n_iters, use_kernel=use_kernel)


def centroid_distances(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Query→centroid squared L2 distances `I` (probing-model input). [Q, B]."""
    return ((q * q).sum(-1, keepdim=True)
            - 2.0 * q @ centroids.T
            + (centroids * centroids).sum(-1)[None, :])
