"""Backend dispatch for the kernels (counterpart of ``repro/kernels/ops.py``).

Two impls: ``"ref"`` (the plain PyTorch versions in ``ref.py``, on any device)
and ``"cuda"`` (the hand-written kernels; for CPU tensors their wrappers take
the plain version). ``impl=None`` follows ``default_impl`` of the tensors'
device. Output rules are the reference's: ids below 0 mark padding, and when
k exceeds the pool the tail is inf / -1. The kernels take any shape: nothing
is padded to a tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import dedup_topk as _dd
from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import l2_topk as _l2
from repro_torch.kernels import l2u8_topk as _l2u8
from repro_torch.kernels import pq_adc as _adc
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rerank_topk as _rr

IMPLS = ("ref", "cuda")


def default_impl(device) -> str:
    """One backend policy for every dispatch layer: the kernels on a CUDA
    device, the plain versions elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def resolve_impl(impl: str | None, device) -> str:
    """Map None/"auto" to ``default_impl(device)``; fail fast on typos."""
    if impl in (None, "auto"):
        return default_impl(device)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of "
                         f"('auto', {', '.join(repr(s) for s in IMPLS)})")
    return impl


def l2_topk(q, cands, cand_ids, k: int, *, impl: str | None = None):
    """Exact top-k of ``q`` [Q, d] against ``cands`` [C, d] with ``cand_ids``
    [C] → ([Q, k], [Q, k])."""
    impl = resolve_impl(impl, cands.device)
    cand_ids = cand_ids.to(torch.int32)
    if impl == "ref":
        return _ref.l2_topk_ref(q, cands, cand_ids, k)
    return _l2.l2_topk(q, cands, cand_ids, k)


def l2_topk_batched(q, cands, cand_ids, k: int, *, impl: str | None = None):
    """Grid-batched top-k scan: [B, Q, d] query buckets vs [B, C, d] candidate
    sets → ([B, Q, k], [B, Q, k])."""
    impl = resolve_impl(impl, cands.device)
    cand_ids = cand_ids.to(torch.int32)
    if impl == "ref":
        return _ref.l2_topk_batched_ref(q, cands, cand_ids, k)
    return _l2.l2_topk_batched(q, cands, cand_ids, k)


def l2_topk_qbuf(q_pad, qbuf, cands, cand_ids, k: int, *, impl: str | None = None):
    """Dispatch-buffer top-k scan: compact ``q_pad`` [R, d] + ``qbuf`` [B, S]
    indices vs [B, C, d] candidate sets → ([B, S, k], [B, S, k]). The
    kernel's group is the autotune cache's for the store shape (C / d / k /
    itemsize); a shape no sweep has seen runs the occupancy calculator's."""
    impl = resolve_impl(impl, cands.device)
    qbuf = qbuf.to(torch.int32)
    cand_ids = cand_ids.to(torch.int32)
    if impl == "ref":
        return _ref.l2_topk_qbuf_ref(q_pad, qbuf, cands, cand_ids, k)
    group = _autotune.lookup(_autotune.l2_key(cands.shape[1], cands.shape[2], k,
                                              cands.element_size()))
    return _l2.l2_topk_qbuf(q_pad, qbuf, cands, cand_ids, k, group=group or 0)


def l2u8_topk_qbuf(q_pad, qbuf, cands, sqnorm, cand_ids, k: int, *, impl: str | None = None):
    """Byte-row dispatch-buffer top-k: compact uint8 ``q_pad`` [R, d] +
    ``qbuf`` [B, S] indices vs uint8 [B, C, d] candidate sets with their
    int32 ``sqnorm`` [B, C] (||x||²) → ([B, S, k] exact integer distances as
    f32, [B, S, k] ids)."""
    impl = resolve_impl(impl, cands.device)
    qbuf = qbuf.to(torch.int32)
    cand_ids = cand_ids.to(torch.int32)
    if impl == "ref":
        return _ref.l2u8_topk_qbuf_ref(q_pad, qbuf, cands, sqnorm, cand_ids, k)
    return _l2u8.l2u8_topk_qbuf(q_pad, qbuf, cands, sqnorm, cand_ids, k)


def pq_adc_topk_qbuf(lut_pad, qbuf, codes, cand_ids, k: int, *, cand_off=None, q_off=None,
                     impl: str | None = None):
    """Dispatch-buffer ADC shortlist: compact ``lut_pad`` [R, m, ks] + ``qbuf``
    [B, S] indices vs [B, N, m] code sets → ([B, S, k], [B, S, k]), with the
    residual offsets ``cand_off`` [B, N] and ``q_off`` [B, S] (None adds
    zero). Codes keep their store dtype (uint8 / uint16); any N is taken.
    The kernel's group is the autotune cache's for the store shape (N / m /
    ks / k / the codes' itemsize), as in ``l2_topk_qbuf``."""
    impl = resolve_impl(impl, codes.device)
    qbuf = qbuf.to(torch.int32)
    cand_ids = cand_ids.to(torch.int32)
    if impl == "ref":
        return _ref.pq_adc_topk_qbuf_ref(lut_pad, qbuf, codes, cand_ids, k,
                                         cand_off=cand_off, q_off=q_off)
    group = _autotune.lookup(_autotune.pq_adc_key(codes.shape[1], codes.shape[2],
                                                  lut_pad.shape[2], k, codes.element_size()))
    return _adc.pq_adc_topk_qbuf(lut_pad, qbuf, codes, cand_ids, k,
                                 cand_off=cand_off, q_off=q_off, group=group or 0)


def rerank_topk_qbuf(q_pad, qbuf, vecs, ids, shortlist, k: int, *, impl: str | None = None):
    """The quantized tiers' exact rerank: compact f32 ``q_pad`` [R, d] +
    ``qbuf`` [B, S] indices vs each slot's shortlist ``shortlist`` [B, S, rk]
    of slot indices (-1 = none) into the [B, C, d] rows ``vecs`` (f32 or
    bf16) with ``ids`` [B, C] → ([B, S, k] f32 distances, [B, S, k] ids),
    the k smallest ||q||² − 2q·x + ||x||² in f32 of each occupied slot."""
    impl = resolve_impl(impl, vecs.device)
    qbuf = qbuf.to(torch.int32)
    ids = ids.to(torch.int32)
    shortlist = shortlist.to(torch.int32)
    if impl == "ref":
        return _ref.rerank_topk_qbuf_ref(q_pad, qbuf, vecs, ids, shortlist, k)
    return _rr.rerank_topk_qbuf(q_pad, qbuf, vecs, ids, shortlist, k)


def pq_adc(lut, codes, *, impl: str | None = None):
    """ADC distances [Q, N] from per-query LUTs [Q, m, ks] and PQ codes
    [N, m] (uint8 / uint16 read as stored), summed over m in order."""
    impl = resolve_impl(impl, codes.device)
    if impl == "ref":
        return _ref.pq_adc_ref(lut, codes)
    return _adc.pq_adc(lut, codes)


def pq_adc_topk(lut, codes, cand_ids, k: int, *, cand_off=None, q_off=None,
                impl: str | None = None):
    """Fused ADC scan + top-k shortlist of [Q, m, ks] LUTs over [N, m] codes
    → ([Q, k] ascending dists inf-padded, [Q, k] ids -1-padded), with the
    residual offsets ``cand_off`` [N] and ``q_off`` [Q] (None adds zero)."""
    impl = resolve_impl(impl, codes.device)
    cand_ids = cand_ids.to(torch.int32)
    if impl == "ref":
        return _ref.pq_adc_topk_ref(lut, codes, cand_ids, k, cand_off=cand_off, q_off=q_off)
    return _adc.pq_adc_topk(lut, codes, cand_ids, k, cand_off=cand_off, q_off=q_off)


def pq_adc_topk_batched(lut, codes, cand_ids, k: int, *, cand_off=None, q_off=None,
                        impl: str | None = None):
    """Grid-batched fused ADC shortlist: [B, Q, m, ks] LUT buckets vs
    [B, N, m] code sets → ([B, Q, k], [B, Q, k]), with the residual offsets
    ``cand_off`` [B, N] and ``q_off`` [B, Q] (None adds zero)."""
    impl = resolve_impl(impl, codes.device)
    cand_ids = cand_ids.to(torch.int32)
    if impl == "ref":
        return _ref.pq_adc_topk_batched_ref(lut, codes, cand_ids, k, cand_off=cand_off,
                                            q_off=q_off)
    return _adc.pq_adc_topk_batched(lut, codes, cand_ids, k, cand_off=cand_off, q_off=q_off)


def dedup_topk(dists, ids, k: int, *, impl: str | None = None, dups=None):
    """Replica-aware merge: collapse duplicate ids to their best distance,
    then exact top-k ordered by (dist, id). Given ``dups`` (int64 [Q], on the
    pool's device), each row's duplicate count is written into it: its slots
    with an id ≥ 0 less the distinct ids among them."""
    impl = resolve_impl(impl, dists.device)
    dists = dists.to(torch.float32)
    ids = ids.to(torch.int32)
    if impl == "ref":
        return _ref.dedup_topk_ref(dists, ids, k, dups=dups)
    return _dd.dedup_topk(dists, ids, k, dups=dups)


def kmeans_assign(x, centroids, *, impl: str | None = None):
    """(argmin centroid [N] int32, min sq-dist [N] f32) per point."""
    impl = resolve_impl(impl, x.device)
    if impl == "ref":
        return _ref.kmeans_assign_ref(x, centroids)
    return _km.kmeans_assign(x, centroids)
