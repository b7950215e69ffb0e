"""Query-aware top-k retrieval and the evaluation engine (paper §3.4, §4);
counterpart of ``repro/core/retrieval.py``.

``partition_topk`` is the one heavy pass: for every (query, partition) the
within-partition top-k (distances and ids), computed on the store's device.
On the card it runs the hand-written dispatch-buffer scan ``l2_topk_qbuf``
over a dense dispatch buffer (every query of a block in every partition);
for a store on the CPU the same ``ops`` call takes its plain version.
Afterwards any probe policy (IVF rank, LIRA σ-threshold, BLISS groups,
fixed-nprobe variants, σ sweeps) is evaluated by masking and merging on the
host in numpy, as in the reference, with the paper's recall / cmp / nprobe
accounting.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.kmeans import centroid_distances
from repro_torch.core.partitions import PartitionStore
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import dedup_topk_np


class PartitionTopK(NamedTuple):
    dists: np.ndarray  # [Q, B, k'] within-partition top-k' sq distances (inf-padded)
    ids: np.ndarray    # [Q, B, k'] matching ids (PAD_ID-padded)
    counts: np.ndarray # [B] true partition fill (for cmp accounting)


def _queries(queries, device) -> torch.Tensor:
    """``queries`` (an array or a tensor) as f32 on ``device``."""
    if isinstance(queries, torch.Tensor):
        return queries.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(queries, np.float32), device=device)


def dense_dispatch(q: torch.Tensor, n_partitions: int):
    """The dispatch-buffer operands that send every query of ``q`` [qb, d]
    to every partition: ``q_pad`` [qb + 1, d] (the queries, then the
    sentinel row, which no slot names) and ``qbuf`` [B, qb] with
    ``qbuf[b, s] = s``."""
    q_pad = torch.cat([q, q.new_zeros((1, q.shape[1]))])
    qbuf = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    return q_pad, qbuf.expand(n_partitions, -1).contiguous()


def partition_topk(store: PartitionStore, queries, k: int, *, q_batch: int = 128) -> PartitionTopK:
    """Blocked within-partition top-k for all queries, on the store's device.

    Each block of ``q_batch`` queries is one ``l2_topk_qbuf`` call over a
    dense dispatch buffer: ascending within each partition, inf / -1 where a
    partition holds fewer than k rows, an earlier row winning an exact tie.
    ``q_batch`` changes the time, never the answer."""
    k = min(k, store.capacity)
    vecs = store.vectors
    q = _queries(queries, vecs.device).to(vecs.dtype)
    qn, b = q.shape[0], store.n_partitions
    out_d = np.empty((qn, b, k), np.float32)
    out_i = np.empty((qn, b, k), np.int32)
    for s in range(0, qn, q_batch):
        q_pad, qbuf = dense_dispatch(q[s:s + q_batch], b)
        d, i = kops.l2_topk_qbuf(q_pad, qbuf, vecs, store.ids, k)  # [B, qb, k]
        out_d[s:s + q_batch] = d.transpose(0, 1).cpu().numpy()
        out_i[s:s + q_batch] = i.transpose(0, 1).cpu().numpy()
    return PartitionTopK(out_d, out_i, store.counts.cpu().numpy())


# ----------------------------------------------------------------- probe policies

def probe_ivf(cent_dist: np.ndarray, nprobe: int) -> np.ndarray:
    """IVF: nearest-`nprobe` centroids. [Q, B] bool."""
    rank = np.argsort(np.argsort(cent_dist, -1), -1)
    return rank < nprobe


def probe_lira(p_hat: np.ndarray, sigma: float) -> np.ndarray:
    """LIRA: p̂ > σ, guaranteeing at least the argmax partition."""
    mask = p_hat > sigma
    best = p_hat.argmax(-1)
    mask[np.arange(len(mask)), best] = True
    return mask


def probe_topn(score: np.ndarray, nprobe: int) -> np.ndarray:
    """Fixed-nprobe by any score (LIRA-fix-nprobe variant; BLISS per group)."""
    rank = np.argsort(np.argsort(-score, -1), -1)
    return rank < nprobe


# ----------------------------------------------------------------- evaluation

class SearchResult(NamedTuple):
    recall: float
    cmp_mean: float          # mean visited points per query (paper `cmp`)
    nprobe_mean: float
    per_query_cmp: np.ndarray
    per_query_nprobe: np.ndarray
    per_query_recall: np.ndarray


def _take_smallest(d: np.ndarray, i: np.ndarray, pool: int):
    """Exact smallest-`pool` columns per row (unordered) via argpartition."""
    if pool >= d.shape[1]:
        return d, i
    part = np.argpartition(d, pool - 1, axis=1)[:, :pool]
    return np.take_along_axis(d, part, 1), np.take_along_axis(i, part, 1)


def _select_pool(dists3: np.ndarray, ids3: np.ndarray, mask: np.ndarray, pool: int,
                 *, j0: int | None = None):
    """Exact smallest-`pool` (dists, ids) per query over probed partitions.

    Lazy k-way merge: each partition's slice is sorted ascending (inf-padded),
    so the global smallest-`pool` almost always lives in the first `j` columns
    of each probed partition. Select there, then verify per row against the
    smallest first-excluded entry (column j over probed partitions): rows
    where an excluded entry could beat the selected pool escalate — window
    doubling if many, per-row full argpartition if few.
    """
    qn, b, kk = dists3.shape
    if j0 is None:
        # window sized so ~3× the pool fits in the probed partitions' heads:
        # keeps the verify-failure (escalation) rate near zero in practice
        nprobe_mean = max(1.0, float(mask.sum(1).mean()))
        j0 = int(np.ceil(3.0 * pool / nprobe_mean))
    j = min(kk, max(8, j0))
    while True:
        if j >= kk or b * j <= pool:
            flat_d = np.where(mask[:, :, None], dists3, np.inf).reshape(qn, b * kk)
            return _take_smallest(flat_d, np.ascontiguousarray(ids3).reshape(qn, b * kk), pool)
        cand_d = np.where(mask[:, :, None], dists3[:, :, :j], np.inf).reshape(qn, b * j)
        cand_i = np.ascontiguousarray(ids3[:, :, :j]).reshape(qn, b * j)
        pd, pi = _take_smallest(cand_d, cand_i, pool)
        tau = pd.max(1)                                      # worst selected
        excl = np.where(mask, dists3[:, :, j], np.inf).min(1)  # best excluded
        bad = ~(excl > tau)            # also catches tau=inf (pool not filled)
        if not bad.any():
            return pd, pi
        if bad.mean() > 0.05 and 2 * j < kk:
            j *= 2
            continue
        flat_d = np.where(mask[bad][:, :, None], dists3[bad], np.inf).reshape(-1, b * kk)
        pd[bad], pi[bad] = _take_smallest(flat_d, ids3[bad].reshape(-1, b * kk), pool)
        return pd, pi


def _count_hits(top_i: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """hits[r] = |top_i[r] ∩ gt[r]| via one flat searchsorted (ids are unique
    per row after dedup; PAD_ID never matches a ground-truth id)."""
    qn, k = gt.shape
    base = np.arange(qn, dtype=np.int64)[:, None] << 32
    hay = np.sort(top_i.astype(np.int64) + base, axis=1).ravel()
    needles = gt.astype(np.int64) + base
    pos = np.searchsorted(hay, needles.ravel())
    pos = np.clip(pos, 0, hay.size - 1)
    return (hay[pos] == needles.ravel()).reshape(qn, k).sum(1)


def merge_topk(ptk: PartitionTopK, probe_mask: np.ndarray, k: int, *, dedup_pool: int = 2):
    """Dedup'd global top-k (dists, ids) for a probe mask — serving-shaped output."""
    qn, b, kk = ptk.dists.shape
    pool_d, pool_i = _select_pool(ptk.dists, ptk.ids, probe_mask, min(dedup_pool * k, b * kk))
    return dedup_topk_np(pool_d, pool_i, k)


def evaluate_probe(
    ptk: PartitionTopK,
    probe_mask: np.ndarray,
    gt_ids: np.ndarray,
    k: int,
    *,
    dedup_pool: int = 2,
) -> SearchResult:
    """Merge within-partition top-k of probed partitions; exact re-rank; dedup
    replica ids (redundant stores repeat an id across partitions — paper §3.3).
    Vectorized: lazy k-way pool selection + sort-based dedup_topk_np."""
    qn, b, kk = ptk.dists.shape
    pool_d, pool_i = _select_pool(ptk.dists, ptk.ids, probe_mask, min(dedup_pool * k, b * kk))
    _, top_i = dedup_topk_np(pool_d, pool_i, k)
    hits = _count_hits(top_i, np.ascontiguousarray(gt_ids[:, :k]))

    per_recall = hits.astype(np.float64) / k
    per_cmp = (probe_mask * ptk.counts[None, :]).sum(-1)
    per_np = probe_mask.sum(-1)
    return SearchResult(
        recall=float(per_recall.mean()),
        cmp_mean=float(per_cmp.mean()),
        nprobe_mean=float(per_np.mean()),
        per_query_cmp=per_cmp,
        per_query_nprobe=per_np,
        per_query_recall=per_recall,
    )


def merge_groups(
    ptks: list[PartitionTopK],
    masks: list[np.ndarray],
    gt_ids: np.ndarray,
    k: int,
    assigns: list[np.ndarray],
    n_base: int,
    *,
    q_block: int = 512,
) -> SearchResult:
    """BLISS-style multi-group merge with exact dedup'd cmp accounting:
    visited(q) = |∪_g {points whose group-g partition is probed}|."""
    qn = masks[0].shape[0]
    # recall via per-group pools, merged with the replica-aware dedup primitive
    pools_d, pools_i = [], []
    for ptk, m in zip(ptks, masks):
        b, kk = ptk.dists.shape[1:]
        pd, pi = _select_pool(ptk.dists, ptk.ids, m, min(k, b * kk))
        pools_d.append(pd)
        pools_i.append(pi)
    _, top_i = dedup_topk_np(np.concatenate(pools_d, 1), np.concatenate(pools_i, 1), k)
    hits = _count_hits(top_i, np.ascontiguousarray(gt_ids[:, :k])).astype(np.float64)

    # exact dedup'd visited counts, blocked over queries
    per_cmp = np.zeros(qn, np.int64)
    for s in range(0, qn, q_block):
        e = min(qn, s + q_block)
        union = np.zeros((e - s, n_base), bool)
        for m, a in zip(masks, assigns):
            union |= m[s:e][:, a]  # [qb, N]: probed(assignment of point)
        per_cmp[s:e] = union.sum(-1)
    per_np = sum(m.sum(-1) for m in masks) / len(masks)
    return SearchResult(
        recall=float((hits / k).mean()),
        cmp_mean=float(per_cmp.mean()),
        nprobe_mean=float(per_np.mean()),
        per_query_cmp=per_cmp,
        per_query_nprobe=per_np,
        per_query_recall=hits / k,
    )


def lira_inputs(store: PartitionStore, queries) -> np.ndarray:
    """Query→centroid distances I [Q, B], computed on the store's device."""
    cents = store.centroids
    return centroid_distances(_queries(queries, cents.device), cents.float()).cpu().numpy()
