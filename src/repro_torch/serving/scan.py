"""Per-partition scan of the serve step (counterpart of
``repro/serving/scan.py``): the f32 tier's fused L2 top-k, the u8 tier's
exact integer L2 top-k over byte rows, or the quantized tiers' two stages —
an ADC shortlist of ``rk`` slots from the shared LUT
(plus the residual offsets), then an exact f32 rerank of the shortlist.
``impl`` picks the plain versions (``"ref"``) or the kernels (``"cuda"``);
both give the same answers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def run(impl: str, qbuf, q_pad, vecs_loc, ids_loc, k: int, *, lut_pad=None, codes_loc=None,
        rk=None, cterm_loc=None, off_loc=None, sqnorm_loc=None):
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
    sqnorm_loc [b_loc, cap] int32  — u8 only: each row's ||x||²; q_pad and
                                     vecs_loc are then uint8

    Returns ([b_loc, q_cap, k] dists, [b_loc, q_cap, k] ids); rows for empty
    slots are dropped by the serve step's scatter.
    """
    if lut_pad is not None:
        return _quantized(impl, qbuf, q_pad, vecs_loc, ids_loc, k, lut_pad, codes_loc, rk,
                          cterm_loc, off_loc)
    if sqnorm_loc is not None:
        return kops.l2u8_topk_qbuf(q_pad, qbuf, vecs_loc, sqnorm_loc, ids_loc, k, impl=impl)
    # cast the compact plane to the store dtype: the quantization point of
    # the reference (bf16 stores see bf16 queries, accumulated in f32)
    qp = q_pad.to(vecs_loc.dtype)
    return kops.l2_topk_qbuf(qp, qbuf, vecs_loc, ids_loc, k, impl=impl)


def _quantized(impl, qbuf, q_pad, vecs_loc, ids_loc, k, lut_pad, codes_loc, rk, cterm_loc,
               off_loc):
    b_loc = qbuf.shape[0]
    cap = vecs_loc.shape[1]
    # stage 1 ranks SLOT indices (-1 where the slot holds no id), so the
    # shortlist can gather the rerank operands
    slots = torch.arange(cap, dtype=torch.int32, device=ids_loc.device).expand(b_loc, cap)
    slots = torch.where(ids_loc < 0, -1, slots)
    qoff = None if off_loc is None else torch.gather(off_loc, 1, qbuf.long())
    _, sl = kops.pq_adc_topk_qbuf(lut_pad, qbuf, codes_loc, slots, rk, cand_off=cterm_loc,
                                  q_off=qoff, impl=impl)

    # stage 2: the exact f32 rerank of each occupied slot's shortlist
    return kops.rerank_topk_qbuf(q_pad, qbuf, vecs_loc, ids_loc, sl, k, impl=impl)


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
