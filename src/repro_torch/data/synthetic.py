"""Deterministic synthetic datasets (numpy only; copies of
``repro/data/synthetic.py``'s functions so the port stands alone: for the
same generator state each gives the reference's bytes).

``make_vector_dataset`` builds a SIFT-like high-dimensional mixture:
  * ``n_modes`` anisotropic Gaussian clusters with power-law weights (local
    density variation — the paper's source of long-tail kNN),
  * a fraction of points placed on *segments between* cluster centers
    (boundary points — these become the long-tail data points),
  * a uniform background floor.
Queries are drawn from the same process (held out).

Also: token streams (LM), criteo-like click logs (recsys), random geometric
graphs and their triplets (DimeNet).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class VectorDataset(NamedTuple):
    base: np.ndarray     # [N, d] f32
    queries: np.ndarray  # [Q, d] f32
    name: str


def make_vector_dataset(
    name: str = "sift-like",
    n: int = 100_000,
    n_queries: int = 1_000,
    dim: int = 128,
    *,
    n_modes: int = 200,
    boundary_frac: float = 0.4,
    noise_frac: float = 0.02,
    center_scale: float = 1.5,
    spread: float = 2.0,
    seed: int = 0,
) -> VectorDataset:
    """Hardness calibrated against the paper's SIFT statistics (B=64, k=100):
    nprobe* ≈ 5, centroid-rank probing waste ≈ 7, long-tail queries ≈ 54%."""
    rng = np.random.default_rng(seed)
    total = n + n_queries

    centers = rng.normal(0, 1.0, (n_modes, dim)).astype(np.float32) * center_scale
    # anisotropic scales per mode (curse-of-dim local density variation)
    scales = (0.3 + rng.gamma(2.0, 0.25, (n_modes, dim))).astype(np.float32) * spread
    weights = rng.pareto(1.5, n_modes) + 0.05
    weights /= weights.sum()

    n_bound = int(total * boundary_frac)
    n_noise = int(total * noise_frac)
    n_core = total - n_bound - n_noise

    modes = rng.choice(n_modes, n_core, p=weights)
    core = centers[modes] + rng.normal(0, 1, (n_core, dim)).astype(np.float32) * scales[modes]

    # boundary points: on segments between pairs of (near) cluster centers
    a = rng.choice(n_modes, n_bound, p=weights)
    # partner = nearest-ish other mode (random among 5 nearest)
    c2 = ((centers[:, None] - centers[None]) ** 2).sum(-1)
    np.fill_diagonal(c2, np.inf)
    near5 = np.argsort(c2, 1)[:, :5]
    b = near5[a, rng.integers(0, 5, n_bound)]
    t = rng.beta(2, 2, n_bound).astype(np.float32)[:, None]
    bound = centers[a] * (1 - t) + centers[b] * t
    bound += rng.normal(0, 1, (n_bound, dim)).astype(np.float32) * 0.5 * (scales[a] + scales[b]) / 2

    lo, hi = centers.min(), centers.max()
    noise = rng.uniform(lo, hi, (n_noise, dim)).astype(np.float32)

    x = np.concatenate([core, bound, noise]).astype(np.float32)
    rng.shuffle(x)
    return VectorDataset(base=x[:n], queries=x[n:], name=name)


def make_token_dataset(n_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Zipf-distributed token stream for LM smoke training."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.3, n_tokens).astype(np.int64)
    return np.clip(ranks, 1, vocab - 1).astype(np.int32)


def make_recsys_batch(
    rng: np.random.Generator,
    batch: int,
    n_dense: int,
    n_sparse: int,
    vocab: int,
    *,
    multi_hot: int = 1,
):
    """Criteo-like log: zipfian sparse ids, log-normal dense, ctr-ish labels."""
    dense = rng.lognormal(0, 1, (batch, n_dense)).astype(np.float32) if n_dense else np.zeros((batch, 0), np.float32)
    ids = np.minimum(rng.zipf(1.2, (batch, n_sparse, multi_hot)), vocab - 1).astype(np.int32)
    # labels correlated with a random linear model over hashed ids
    w = rng.normal(0, 1, n_sparse)
    logit = (np.sin(ids[..., 0] * 0.37) * w).sum(-1) * 0.5
    label = (rng.uniform(size=batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return {"dense": dense, "sparse_ids": ids, "label": label}


def make_geometric_graph(rng: np.random.Generator, n_nodes: int, avg_degree: int, d_feat: int):
    """Random geometric-ish graph via kNN in a latent 3D space (gives DimeNet
    meaningful angles). Returns positions, features, edge_index [2, E]. Forms
    the [N, N, 3] difference array: 88 MB at 2,708 nodes, 347 GB at 169,984."""
    pos = rng.normal(0, 1, (n_nodes, 3)).astype(np.float32)
    k = max(1, avg_degree)
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, 1)[:, :k]                      # [N, k]
    src = np.repeat(np.arange(n_nodes), k)
    dst = nbr.reshape(-1)
    edge_index = np.stack([src, dst]).astype(np.int32)  # j -> i convention: row0=src j, row1=dst i
    feat = rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32)
    return pos, feat, edge_index


def build_triplets(edge_index: np.ndarray, max_triplets: int | None = None, seed: int = 0):
    """DimeNet triplet list: for each directed edge (j→i), all edges (k→j), k≠i.
    Returns (edge_kj, edge_ji) index pairs [T]."""
    rng = np.random.default_rng(seed)
    src, dst = edge_index
    e = len(src)
    # edges into j: group edge ids by their dst
    by_dst: dict[int, list[int]] = {}
    for eid in range(e):
        by_dst.setdefault(int(dst[eid]), []).append(eid)
    kj, ji = [], []
    for eid in range(e):
        j, i = int(src[eid]), int(dst[eid])
        for eid2 in by_dst.get(j, ()):
            if int(src[eid2]) != i:
                kj.append(eid2)
                ji.append(eid)
    kj = np.asarray(kj, np.int32)
    ji = np.asarray(ji, np.int32)
    if max_triplets is not None and len(kj) > max_triplets:
        sel = rng.choice(len(kj), max_triplets, replace=False)
        kj, ji = kj[sel], ji[sel]
    return kj, ji
