"""Per-partition scan of the serve step (counterpart of
``repro/serving/scan.py``): the f32 tier's fused L2 top-k, or the quantized
tiers' two stages — an ADC shortlist of ``rk`` slots from the shared LUT
(plus the residual offsets), then an exact f32 rerank of the shortlist.
``impl`` picks the plain versions (``"ref"``) or the kernels (``"cuda"``);
both give the same answers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import smallest_k

# elements of one rerank chunk's [pairs, rk, d] candidate gather
_RERANK_CHUNK = 1 << 28


def run(impl: str, qbuf, q_pad, vecs_loc, ids_loc, k: int, *, lut_pad=None, codes_loc=None,
        rk=None, cterm_loc=None, off_loc=None):
    """Scan every partition's candidates for its dispatched queries.

    qbuf      [b_loc, q_cap] int32 — query row per slot, ``q_row`` = empty
    q_pad     [q_row + 1, d]       — queries + sentinel row for empty slots
    vecs_loc  [b_loc, cap, d]      — partition vectors (store dtype)
    ids_loc   [b_loc, cap] int32   — point ids, -1 = padding / hole
    lut_pad   [q_row + 1, m, ks]   — quantized only: shared ADC LUTs + zero row
    codes_loc [b_loc, cap, m]      — quantized only: PQ codes
    rk        int                  — quantized only: shortlist depth
    cterm_loc [b_loc, cap]         — residual only: per-slot cross terms
    off_loc   [b_loc, q_row + 1]   — residual only: per-(partition, query)
                                     offsets, zero column for empty slots

    Returns ([b_loc, q_cap, k] dists, [b_loc, q_cap, k] ids); rows for empty
    slots are dropped by the serve step's scatter.
    """
    if lut_pad is not None:
        return _quantized(impl, qbuf, q_pad, vecs_loc, ids_loc, k, lut_pad, codes_loc, rk,
                          cterm_loc, off_loc)
    # cast the compact plane to the store dtype: the quantization point of
    # the reference (bf16 stores see bf16 queries, accumulated in f32)
    qp = q_pad.to(vecs_loc.dtype)
    return kops.l2_topk_qbuf(qp, qbuf, vecs_loc, ids_loc, k, impl=impl)


def _quantized(impl, qbuf, q_pad, vecs_loc, ids_loc, k, lut_pad, codes_loc, rk, cterm_loc,
               off_loc):
    b_loc, q_cap = qbuf.shape
    cap = vecs_loc.shape[1]
    # stage 1 ranks SLOT indices (-1 where the slot holds no id), so the
    # shortlist can gather the rerank operands
    slots = torch.arange(cap, dtype=torch.int32, device=ids_loc.device).expand(b_loc, cap)
    slots = torch.where(ids_loc < 0, -1, slots)
    qoff = None if off_loc is None else torch.gather(off_loc, 1, qbuf.long())
    _, sl = kops.pq_adc_topk_qbuf(lut_pad, qbuf, codes_loc, slots, rk, cand_off=cterm_loc,
                                  q_off=qoff, impl=impl)

    # stage 2: exact f32 rerank of the occupied slots' shortlists only; the
    # empty slots' rows stay inf / -1. Chunked over (bucket, slot) pairs so
    # the [pairs, rk, d] gather stays bounded.
    out_d = torch.full((b_loc, q_cap, k), torch.inf, dtype=torch.float32, device=qbuf.device)
    out_i = torch.full((b_loc, q_cap, k), -1, dtype=torch.int32, device=qbuf.device)
    bb, ss = torch.nonzero(qbuf < q_pad.shape[0] - 1, as_tuple=True)
    step = max(1, _RERANK_CHUNK // (rk * vecs_loc.shape[2]))
    for p0 in range(0, len(bb), step):
        b, s = bb[p0:p0 + step], ss[p0:p0 + step]
        short = sl[b, s].long()                                  # [P, rk]
        safe = short.clamp_min(0)
        cid = torch.where(short >= 0, ids_loc[b[:, None], safe], -1)
        cand = vecs_loc[b[:, None], safe].float()                # [P, rk, d]
        qs = q_pad[qbuf[b, s].long()].float()                    # [P, d]
        d2 = ((qs * qs).sum(-1)[:, None]
              - 2.0 * torch.bmm(cand, qs[:, :, None])[..., 0]
              + (cand * cand).sum(-1))
        d2 = torch.where(cid < 0, torch.inf, d2)
        if d2.shape[1] < k:  # a shortlist shorter than k: pad to a defined top-k
            d2 = torch.cat([d2, d2.new_full((d2.shape[0], k - d2.shape[1]), torch.inf)], 1)
            cid = torch.cat([cid, cid.new_full((cid.shape[0], k - cid.shape[1]), -1)], 1)
        top_d, pos = smallest_k(d2, k)
        out_d[b, s] = top_d
        out_i[b, s] = torch.gather(cid, 1, pos)
    return out_d, out_i


# ----------------------------------------------------------- bytes accounting

def staged_operand_bytes(qbuf, plane) -> dict:
    """Stage 1's per-query operand staging for a dispatch shape. ``plane``
    is the compact per-query operand the scan reads through ``qbuf`` —
    ``q_pad`` [q_row + 1, d] for the f32 tier, ``lut_pad`` [q_row + 1, m,
    ks] for the quantized tiers. Returns ``compact_bytes`` (the plane and
    the int32 ``qbuf``, what the qbuf scans stage) and ``expanded_bytes``
    (one plane row a dispatch slot, what a ``plane[qbuf]`` gather would
    materialize). Takes tensors or meta tensors: only shapes and dtypes are
    read."""
    b_loc, q_cap = qbuf.shape
    row_elems = 1
    for s in plane.shape[1:]:
        row_elems *= int(s)
    row_bytes = row_elems * plane.dtype.itemsize
    return {"compact_bytes": int(plane.shape[0]) * row_bytes + b_loc * q_cap * 4,
            "expanded_bytes": b_loc * q_cap * row_bytes}
