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
    device; the picks stay on the device (no host sync per centroid). When
    every D² is zero (fewer distinct points than clusters) the pick is row 0,
    as the reference's ``jax.random.choice`` makes it."""
    n = x.shape[0]
    k0 = torch.randint(n, (1,), generator=generator, device=x.device)
    first = x[k0[0]]
    cents = torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = first
    d2 = ((x - first) ** 2).sum(-1)
    first_row = (torch.arange(n, device=x.device) == 0).to(d2.dtype)
    for i in range(1, n_clusters):
        total = d2.sum()
        probs = torch.where(total > 0, d2 / total.clamp_min(1e-12), first_row)
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


def plus_plus_init_batched(x: torch.Tensor, n_clusters: int,
                           generator: torch.Generator) -> torch.Tensor:
    """``plus_plus_init`` over G independent groups at once: x [G, N, d] →
    [G, n_clusters, d], one D² draw a group a step (a group whose D² is all
    zero picks its row 0)."""
    g, n, d = x.shape
    rows = torch.arange(g, device=x.device)
    k0 = torch.randint(n, (g,), generator=generator, device=x.device)
    cents = torch.zeros((g, n_clusters, d), dtype=x.dtype, device=x.device)
    cents[:, 0] = x[rows, k0]
    d2 = ((x - cents[:, :1]) ** 2).sum(-1)
    first_row = (torch.arange(n, device=x.device) == 0).to(d2.dtype)
    for i in range(1, n_clusters):
        total = d2.sum(-1, keepdim=True)
        probs = torch.where(total > 0, d2 / total.clamp_min(1e-12), first_row)
        new_c = x[rows, torch.multinomial(probs, 1, generator=generator)[:, 0]]
        cents[:, i] = new_c
        d2 = torch.minimum(d2, ((x - new_c[:, None]) ** 2).sum(-1))
    return cents


def _assign_batched(x: torch.Tensor, cents: torch.Tensor):
    """[G, N, d] × [G, S, d] → (argmin [G, N] int64, its sq distance [G, N]):
    ``kmeans_assign_ref``'s expansion, a batched matmul."""
    d2 = ((x * x).sum(-1, keepdim=True) - 2.0 * torch.bmm(x, cents.transpose(1, 2))
          + (cents * cents).sum(-1)[:, None, :])
    a = torch.argmin(d2, dim=-1)
    return a, torch.gather(d2, -1, a[..., None])[..., 0]


def lloyd_batched(x: torch.Tensor, centroids: torch.Tensor, n_iters: int) -> KMeansState:
    """``lloyd`` over G independent groups at once: x [G, N, d] from
    centroids [G, S, d]; each group's sums run in row order, as ``lloyd``'s.
    Returns centroids [G, S, d], assign [G, N] int32 and inertia [G]."""
    x = x.float()
    cents = centroids.float().clone()
    g, s = cents.shape[:2]
    off = (torch.arange(g, device=x.device) * s)[:, None]
    flat = x.reshape(-1, x.shape[-1])
    for _ in range(n_iters):
        a, _ = _assign_batched(x, cents)
        seg = (a + off).reshape(-1)
        sums = segment_sum(flat, seg, g * s).reshape(g, s, -1)
        counts = torch.bincount(seg, minlength=g * s).float().reshape(g, s)
        cents = torch.where(counts[..., None] > 0,
                            sums / counts.clamp_min(1.0)[..., None], cents)
    a, d2 = _assign_batched(x, cents)
    return KMeansState(centroids=cents, assign=a.to(torch.int32), inertia=d2.sum(-1))


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
