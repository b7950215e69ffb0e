"""Padded partition storage (inverted lists with static shapes); counterpart
of ``repro/core/partitions.py``.

Inverted lists are a dense ``[B, capacity, d]`` tensor plus per-partition
counts. Rows beyond ``count`` are padding (id = -1, vector = 1e6 so they
never win a top-k). A store may also carry a mini-IVF inside every partition
(``attach_internal_index``): the two-level index.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.kmeans import lloyd_batched, plus_plus_init_batched
from repro_torch.utils.device import input_device

PAD_ID = -1
# elements of the [partitions, capacity, max(S, d)] block one sub-k-means step
# holds: bounds attach_internal_index's memory at full width
_SUB_BLOCK = 1 << 28


class PartitionStore(NamedTuple):
    centroids: torch.Tensor   # [B, d] f32
    vectors: torch.Tensor     # [B, capacity, d] f32 (padded)
    ids: torch.Tensor         # [B, capacity] int32, PAD_ID marks padding
    counts: torch.Tensor      # [B] int32
    # optional internal mini-IVF (two-level index)
    sub_centroids: Optional[torch.Tensor] = None  # [B, S, d] f32
    sub_assign: Optional[torch.Tensor] = None     # [B, capacity] int32 in [0, S)

    @property
    def n_partitions(self) -> int:
        return self.vectors.shape[0]

    @property
    def capacity(self) -> int:
        return self.vectors.shape[1]


def build_store(x, ids, assign, centroids, *, capacity: Optional[int] = None,
                extra=None, device=None) -> PartitionStore:
    """Build padded lists on ``device`` (default: x's device when it is a
    tensor, else the card, raising when there is none).

    ``extra`` = (vectors, ids, assign) replica rows appended by the
    redundancy strategy (paper §3.3); replicas share the id of the original
    point so the merge step dedups naturally. Rows are placed in a stable
    by-partition order (originals first, then replicas, each in input order),
    and each partition keeps its first ``capacity`` rows — the reference's
    per-row loop, vectorized.
    """
    device = input_device(device, x)

    def t(a, dtype):
        return torch.as_tensor(a, device=device).to(dtype)

    xs = [t(x, torch.float32)]
    xid = [t(ids, torch.int32)]
    xa = [t(assign, torch.int64)]
    if extra is not None and len(extra[0]):
        xs.append(t(extra[0], torch.float32))
        xid.append(t(extra[1], torch.int32))
        xa.append(t(extra[2], torch.int64))
    x_all, id_all, a_all = torch.cat(xs), torch.cat(xid), torch.cat(xa)

    cents = t(centroids, torch.float32)
    b, d = cents.shape[0], x_all.shape[1]
    counts = torch.bincount(a_all, minlength=b)
    cap = int(capacity if capacity is not None else max(1, int(counts.max())))
    pa, order = torch.sort(a_all, stable=True)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(pa), device=device) - start[pa]
    keep = rank < cap
    vec = torch.full((b, cap, d), 1e6, dtype=torch.float32, device=device)
    pid = torch.full((b, cap), PAD_ID, dtype=torch.int32, device=device)
    vec[pa[keep], rank[keep]] = x_all[order[keep]]
    pid[pa[keep], rank[keep]] = id_all[order[keep]]
    return PartitionStore(centroids=cents, vectors=vec, ids=pid,
                          counts=counts.clamp_max(cap).to(torch.int32))


def attach_internal_index(store: PartitionStore, n_sub: int, n_iters: int = 8, *,
                          generator: Optional[torch.Generator] = None,
                          init: Optional[torch.Tensor] = None) -> PartitionStore:
    """Two-level index: a mini-IVF of ``n_sub`` sub-clusters inside every
    partition, one k-means a partition over all of its ``capacity`` rows,
    padding rows included (each a 1e6-valued point the sub-k-means assigns
    like any other, as the reference's vmapped fit does).

    Each fit starts from ``init[b]`` ([B, S, d] starting sub-centroids) when
    given, else from k-means++ on ``generator`` (on the store's device), then
    runs ``n_iters`` Lloyd iterations. The fits run batched over blocks of
    partitions."""
    if init is None and generator is None:
        raise ValueError("attach_internal_index needs a generator or init")
    vecs = store.vectors.float()
    b, cap, d = vecs.shape
    step = max(1, _SUB_BLOCK // (cap * max(n_sub, d)))
    sub_c, sub_a = [], []
    for b0 in range(0, b, step):
        x = vecs[b0:b0 + step]
        start = (torch.as_tensor(init[b0:b0 + step], dtype=torch.float32, device=vecs.device)
                 if init is not None else plus_plus_init_batched(x, n_sub, generator))
        st = lloyd_batched(x, start, n_iters)
        sub_c.append(st.centroids)
        sub_a.append(st.assign)
    return store._replace(sub_centroids=torch.cat(sub_c), sub_assign=torch.cat(sub_a))


def store_stats(store: PartitionStore) -> dict:
    """Partition count, capacity, rows held, fill extremes and imbalance."""
    counts = store.counts.cpu().numpy()
    return {
        "B": store.n_partitions,
        "capacity": store.capacity,
        "total": int(counts.sum()),
        "max_fill": int(counts.max()),
        "min_fill": int(counts.min()),
        "imbalance": float(counts.max() / max(1.0, counts.mean())),
    }
