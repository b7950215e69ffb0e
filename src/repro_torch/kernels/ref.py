"""Plain PyTorch versions of the kernels (counterpart of
``repro/kernels/ref.py``). They are the oracles the CUDA kernels are held
against on the card, and what the wrappers run for CPU tensors.

``jax.lax.top_k`` breaks ties by the lowest index; ``torch.topk`` promises no
order. Every top-k here is a stable ascending sort cut at k, which keeps the
lowest-index-first rule.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._util import pad_dim

PAD_ID = -1
ID_SENTINEL = 2**30    # id sentinel: sorts after every real id
_ASSIGN_BLOCK = 65536  # rows per block of the plain k-means assignment


def smallest_k(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, ties to the lowest index (``jax.lax.top_k(-x, k)``)."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def l2_topk_ref(q: torch.Tensor, cands: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """[Q,d] x [C,d] -> (top-k sq dists [Q,k], ids [Q,k]); cand_ids<0 = padding."""
    out_d, out_i = l2_topk_batched_ref(q[None], cands[None], cand_ids[None], k)
    return out_d[0], out_i[0]


def l2_topk_batched_ref(q: torch.Tensor, cands: torch.Tensor, cand_ids: torch.Tensor,
                        k: int):
    """[B,Q,d] x [B,C,d] -> ([B,Q,k], [B,Q,k]): the flat oracle per bucket."""
    q = q.float()
    c = cands.float()
    d2 = ((q * q).sum(-1, keepdim=True)
          - 2.0 * torch.matmul(q, c.transpose(1, 2))
          + (c * c).sum(-1)[:, None, :])
    ids = cand_ids.to(torch.int32)
    d2 = torch.where(ids[:, None, :] < 0, torch.inf, d2)
    if d2.shape[2] < k:  # degenerate pools: pad so the top-k is well-defined
        d2 = pad_dim(d2, 2, k, torch.inf)
        ids = pad_dim(ids, 1, k, PAD_ID)
    out_d, pos = smallest_k(d2, k)
    out_i = torch.gather(ids[:, None, :].expand(-1, d2.shape[1], -1), 2, pos)
    return out_d, torch.where(torch.isfinite(out_d), out_i, PAD_ID)


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor):
    """(argmin centroid [N] int32, its sq distance [N] f32) per point, by the
    expansion ||x||² − 2x·c + ||c||² in f32: a matmul then an argmin (the
    first minimum wins, as JAX's), over blocks of rows so the [rows, B]
    distance matrix stays bounded."""
    x, c = x.float(), centroids.float()
    assign = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    dmin = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    c2 = (c * c).sum(-1)[None, :]
    for s in range(0, x.shape[0], _ASSIGN_BLOCK):
        xb = x[s:s + _ASSIGN_BLOCK]
        d2 = (xb * xb).sum(-1, keepdim=True) - 2.0 * xb @ c.T + c2
        a = torch.argmin(d2, dim=-1)
        assign[s:s + _ASSIGN_BLOCK] = a.to(torch.int32)
        dmin[s:s + _ASSIGN_BLOCK] = torch.gather(d2, 1, a[:, None])[:, 0]
    return assign, dmin


def l2_topk_qbuf_ref(q_pad: torch.Tensor, qbuf: torch.Tensor, cands: torch.Tensor,
                     cand_ids: torch.Tensor, k: int):
    """Oracle for the dispatch-buffer scan: materializes the dense ``[B,S,d]``
    gather ``q_pad[qbuf]`` that the kernel avoids, then the batched oracle."""
    return l2_topk_batched_ref(q_pad[qbuf.long()], cands, cand_ids, k)


# ---------------------------------------------------------------- PQ / ADC
#
# The ADC sum runs over the subspaces in order, m = 0 … m−1, then adds q_off,
# then cand_off: the order of the TPU kernel (pq_adc.py:345) and of the serve
# path, so the CUDA kernel, which only adds, equals these bit for bit. (The
# reference's flat oracle adds cand_off before q_off; the two agree within
# rounding.) An offset of None adds nothing.

# elements of one chunk's [buckets, slots, candidates] distance block: bounds
# the plain version's memory at the serve path's widths
_ADC_CHUNK = 1 << 25


def _adc_sum(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[G, Q, m, ks] LUTs × [G, N, m] codes → [G, Q, N] f32, summed over m in
    order."""
    g, q, m, _ = lut.shape
    n = codes.shape[1]
    lut = lut.float()
    d = None
    for j in range(m):
        idx = codes[:, None, :, j].long().expand(g, q, n)
        term = torch.gather(lut[:, :, j], 2, idx)
        d = term if d is None else d + term
    return d


def _adc_sum_rows(lut_pad: torch.Tensor, rows: torch.Tensor,
                  codes: torch.Tensor) -> torch.Tensor:
    """``_adc_sum`` of the LUTs ``lut_pad[rows]`` ([R, m, ks] rows through
    [G, Q] indices) × [G, N, m] codes → [G, Q, N] f32, read from the compact
    plane: no [G, Q, m, ks] copy is made."""
    rows = rows.long()[:, :, None]
    d = None
    for j in range(codes.shape[2]):
        term = lut_pad[:, j].float()[rows, codes[:, None, :, j].long()]
        d = term if d is None else d + term
    return d


def _adc_topk(d: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """Mask ids < 0 and take the k smallest of [G, Q, N] distances."""
    ids = cand_ids.to(torch.int32)
    d = torch.where(ids[:, None, :] < 0, torch.inf, d)
    if d.shape[2] < k:  # degenerate pools: pad so the top-k is well-defined
        d = pad_dim(d, 2, k, torch.inf)
        ids = pad_dim(ids, 1, k, PAD_ID)
    out_d, pos = smallest_k(d, k)
    out_i = torch.gather(ids[:, None, :].expand(-1, d.shape[1], -1), 2, pos)
    return out_d, torch.where(torch.isfinite(out_d), out_i, PAD_ID)


def pq_adc_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """dist[q, n] = Σ_m lut[q, m, codes[n, m]]: [Q, m, ks] × [N, m] → [Q, N]."""
    return _adc_sum(lut[None], codes[None])[0]


def pq_adc_topk_ref(lut: torch.Tensor, codes: torch.Tensor, cand_ids: torch.Tensor, k: int,
                    cand_off=None, q_off=None):
    """Fused ADC + top-k: ([Q, k] ascending dists inf-padded, [Q, k] ids
    -1-padded). ``q_off`` [Q] shifts a query's distances, ``cand_off`` [N]
    a candidate's (the residual-PQ offsets, core/pq.py)."""
    out_d, out_i = pq_adc_topk_batched_ref(
        lut[None], codes[None], cand_ids[None], k,
        cand_off=None if cand_off is None else cand_off[None],
        q_off=None if q_off is None else q_off[None])
    return out_d[0], out_i[0]


def pq_adc_topk_batched_ref(lut: torch.Tensor, codes: torch.Tensor, cand_ids: torch.Tensor,
                            k: int, cand_off=None, q_off=None):
    """[B, Q, m, ks] × [B, N, m] → ([B, Q, k], [B, Q, k]), with the offsets
    ``q_off`` [B, Q] and ``cand_off`` [B, N]."""
    qbuf = torch.arange(lut.shape[0] * lut.shape[1], dtype=torch.int64,
                        device=lut.device).reshape(lut.shape[:2])
    return pq_adc_topk_qbuf_ref(lut.reshape(-1, *lut.shape[2:]), qbuf, codes, cand_ids, k,
                                cand_off=cand_off, q_off=q_off)


def pq_adc_topk_qbuf_ref(lut_pad: torch.Tensor, qbuf: torch.Tensor, codes: torch.Tensor,
                         cand_ids: torch.Tensor, k: int, cand_off=None, q_off=None):
    """Oracle for the dispatch-buffer ADC scan: ``lut_pad`` [R, m, ks] rows
    read through ``qbuf`` [B, S] against ``codes`` [B, N, m], never copied a
    slot (no [B, S, m, ks] tensor, as in the kernel). Buckets go in chunks,
    and a bucket too big for one chunk in chunks of slots, so the
    ``[B, S, N]`` distances are never whole (the flat form over 1M codes is
    one bucket of 1,000 slots)."""
    b, s = qbuf.shape
    n = codes.shape[1]
    per_slot = max(1, n)
    s_step = max(1, min(s, _ADC_CHUNK // per_slot))   # slots, when one bucket is too big
    b_step = max(1, _ADC_CHUNK // (s * per_slot)) if s else 1
    out_d = torch.empty((b, s, k), dtype=torch.float32, device=lut_pad.device)
    out_i = torch.empty((b, s, k), dtype=torch.int32, device=lut_pad.device)
    for b0 in range(0, b, b_step):
        bs = slice(b0, b0 + b_step)
        for s0 in range(0, s, s_step):
            ss = slice(s0, s0 + s_step)
            d = _adc_sum_rows(lut_pad, qbuf[bs, ss], codes[bs])
            if q_off is not None:
                d = d + q_off[bs, ss].float()[:, :, None]
            if cand_off is not None:
                d = d + cand_off[bs].float()[:, None, :]
            out_d[bs, ss], out_i[bs, ss] = _adc_topk(d, cand_ids[bs], k)
    return out_d, out_i


def dedup_topk_ref(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Exact replica-aware merge of a candidate pool.

    [Q,P] dists (non-finite = masked/invalid) × [Q,P] ids (<0 = padding) →
    ([Q,k] ascending dists inf-padded, [Q,k] ids -1-padded). Each id appears at
    most once per row, carrying its smallest distance; the output is ordered
    by (dist, id). Sort by dist, stable-sort by id (so per-id groups stay
    distance-ordered), kill adjacent duplicates, top-k the survivors.
    """
    d = dists.float()
    ids = ids.to(torch.int32)
    if d.shape[1] < k:  # degenerate pools: pad so the top-k is well-defined
        d = pad_dim(d, 1, k, torch.inf)
        ids = pad_dim(ids, 1, k, PAD_ID)
    valid = (ids >= 0) & torch.isfinite(d)
    ids = torch.where(valid, ids, ID_SENTINEL)
    d = torch.where(valid, d, torch.inf)
    d1, o1 = torch.sort(d, dim=1, stable=True)
    i1 = torch.gather(ids, 1, o1)
    i2, o2 = torch.sort(i1, dim=1, stable=True)
    d2 = torch.gather(d1, 1, o2)
    first = torch.ones_like(i2, dtype=torch.bool)
    first[:, 1:] = i2[:, 1:] != i2[:, :-1]
    d3 = torch.where(first & (i2 != ID_SENTINEL), d2, torch.inf)
    out_d, pos = smallest_k(d3, k)
    out_i = torch.where(torch.isfinite(out_d), torch.gather(i2, 1, pos), PAD_ID)
    return out_d, out_i


def dedup_topk_np(dists: np.ndarray, ids: np.ndarray, k: int):
    """Numpy twin of ``dedup_topk_ref`` for host-side callers (a copy of
    ``repro/kernels/dedup_topk.py:dedup_topk_np``).

    One sort instead of two: pack (id, dist) into a single uint64 key — the
    high 32 bits are the id, the low 32 the IEEE-754 total-order image of the
    float32 distance (sign bit set for non-negative floats, bitwise-NOT for
    negative ones — a monotone uint32 map incl. ±0/inf/nan). Sorting the key
    groups ids with the best distance first.
    """
    q, p = dists.shape
    d = np.ascontiguousarray(dists, dtype=np.float32)
    ids = np.asarray(ids, np.int32)
    valid = (ids >= 0) & np.isfinite(d)
    d_s = np.where(valid, d, np.inf)
    ids_s = np.where(valid, ids, ID_SENTINEL)
    u = np.ascontiguousarray(d_s).view(np.uint32)
    du = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    key = (ids_s.astype(np.uint64) << np.uint64(32)) | du
    order = np.argsort(key, axis=1)
    k2 = np.take_along_axis(key, order, 1)
    i2 = np.take_along_axis(ids_s, order, 1)
    d2 = np.take_along_axis(d_s, order, 1)
    first = np.concatenate([np.ones((q, 1), bool), i2[:, 1:] != i2[:, :-1]], axis=1)
    keep = first & (i2 != ID_SENTINEL)
    d3 = np.where(keep, d2, np.inf)
    # final selection orders by (dist, id) — swap the key halves so distance
    # leads and ids break exact-distance ties deterministically
    fkey = np.where(keep, (k2 << np.uint64(32)) | (k2 >> np.uint64(32)),
                    np.uint64(0xFFFFFFFFFFFFFFFF))
    kk = min(k, p)
    if kk < p:
        part = np.argpartition(fkey, kk - 1, axis=1)[:, :kk]
        fkey = np.take_along_axis(fkey, part, 1)
        d3 = np.take_along_axis(d3, part, 1)
        i2 = np.take_along_axis(i2, part, 1)
    o3 = np.argsort(fkey, axis=1)
    out_d = np.full((q, k), np.inf, np.float32)
    out_i = np.full((q, k), PAD_ID, np.int32)
    out_d[:, :kk] = np.take_along_axis(d3, o3, 1)
    oi = np.take_along_axis(i2, o3, 1)
    out_i[:, :kk] = np.where(np.isfinite(out_d[:, :kk]), oi, PAD_ID)
    return out_d, out_i
