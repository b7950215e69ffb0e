"""Wrapper of the quantized tiers' exact rerank ``csrc/rerank_topk_qbuf.cu``
(the port's own kernel: the JAX package reranks the ADC shortlist with plain
jnp ops, ``repro/serving/scan.py``).

For tensors that are not on the card it runs the plain version (``ref.py``);
for CUDA tensors it launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# kernel launches since the last reset
launches = 0

# vector plane dtype → entry point; rows are read in their store dtype
_STORE = {torch.float32: "rerank_topk_qbuf_f32", torch.bfloat16: "rerank_topk_qbuf_bf16"}


def _lib():
    lib = _build.load("rerank_topk_qbuf")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in _STORE.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr, i32, i32, ptr, i32, i32, ptr, ptr,
                          ptr]
            f.restype = i32
        lib._typed = True
    return lib


def _check(q_pad, qbuf, vecs, ids, shortlist, k):
    if vecs.device.type != "cuda":
        raise ValueError(f"rerank_topk_qbuf: unsupported device {vecs.device}")
    if vecs.dtype not in _STORE:
        raise TypeError(f"rerank_topk_qbuf: store dtype {vecs.dtype} not in {list(_STORE)}")
    if q_pad.dtype != torch.float32:
        raise TypeError(f"rerank_topk_qbuf: q_pad is {q_pad.dtype}, not float32")
    for name, t in (("qbuf", qbuf), ("ids", ids), ("shortlist", shortlist)):
        if t.dtype != torch.int32:
            raise TypeError(f"rerank_topk_qbuf: {name} is {t.dtype}, not int32")
    for name, t in (("q_pad", q_pad), ("qbuf", qbuf), ("ids", ids), ("shortlist", shortlist)):
        if t.device != vecs.device:
            raise ValueError(f"rerank_topk_qbuf: {name} on {t.device}, store on {vecs.device}")
    b, c, d = vecs.shape
    if q_pad.ndim != 2 or q_pad.shape[1] != d or q_pad.shape[0] < 1:
        raise ValueError(f"rerank_topk_qbuf: q_pad {tuple(q_pad.shape)} vs store dim {d}")
    if (qbuf.ndim != 2 or qbuf.shape[0] != b or tuple(ids.shape) != (b, c)
            or shortlist.ndim != 3 or tuple(shortlist.shape[:2]) != tuple(qbuf.shape)):
        raise ValueError(f"rerank_topk_qbuf: qbuf {tuple(qbuf.shape)} / ids "
                         f"{tuple(ids.shape)} / shortlist {tuple(shortlist.shape)} vs store "
                         f"{tuple(vecs.shape)}")
    if k < 1:
        raise ValueError(f"rerank_topk_qbuf: k={k}")
    return (q_pad.contiguous(), qbuf.contiguous(), vecs.contiguous(), ids.contiguous(),
            shortlist.contiguous())


def rerank_topk_qbuf(q_pad: torch.Tensor, qbuf: torch.Tensor, vecs: torch.Tensor,
                     ids: torch.Tensor, shortlist: torch.Tensor, k: int):
    """Exact top-k of every occupied dispatch slot's shortlist.

    q_pad     [R, d]      f32 queries; row R-1 is the empty slots'
    qbuf      [B, S]      int32 query row per dispatch slot, R-1 = empty
    vecs      [B, C, d]   f32 or bf16 partition rows, read in that dtype
    ids       [B, C]      int32 ids, < 0 = padding / hole
    shortlist [B, S, rk]  int32 slot indices of each slot's shortlist, -1 = none

    Returns ([B, S, k] f32 ascending distances ||q||² − 2q·x + ||x||² in
    f32, [B, S, k] int32 ids): +inf for a -1 entry or a slot whose id is
    < 0, inf / -1 past rk, the lower shortlist position first on an exact
    tie. Empty slots come back as inf / -1 without being read.
    """
    global launches
    if vecs.device.type != "cuda":
        return _ref.rerank_topk_qbuf_ref(q_pad, qbuf, vecs, ids, shortlist, k)
    q_pad, qbuf, vecs, ids, shortlist = _check(q_pad, qbuf, vecs, ids, shortlist, k)
    (b, c, d), (s, rk), lib = vecs.shape, shortlist.shape[1:], _lib()
    with torch.cuda.device(vecs.device):
        od = torch.empty((b, s, k), dtype=torch.float32, device=vecs.device)
        oi = torch.empty((b, s, k), dtype=torch.int32, device=vecs.device)
        err = getattr(lib, _STORE[vecs.dtype])(
            q_pad.data_ptr(), q_pad.shape[0], qbuf.data_ptr(), b, s, vecs.data_ptr(),
            ids.data_ptr(), c, d, shortlist.data_ptr(), rk, k, od.data_ptr(), oi.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"rerank_topk_qbuf (S={s}, rk={rk}, d={d}, k={k}, {vecs.dtype})")
    launches += 1
    return od, oi
