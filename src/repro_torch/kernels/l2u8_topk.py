"""Wrapper of the byte-row dispatch-buffer scan ``csrc/l2u8_topk_qbuf.cu``:
the u8 tier's exact integer L2 top-k (the port's own kernel; the JAX package
has no 8-bit tier).

For a CPU tensor it runs the plain version (``ref.py``); for a CUDA tensor it
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# kernel launches since the last reset
launches = 0


def _lib():
    lib = _build.load("l2u8_topk_qbuf")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.l2u8_topk_qbuf.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32,
                                       ptr, ptr, ptr, ptr]
        lib.l2u8_topk_qbuf.restype = i32
        lib.l2u8_topk_qbuf_workspace.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i64)]
        lib.l2u8_topk_qbuf_workspace.restype = None
        lib._typed = True
    return lib


def _check(q_pad, qbuf, cands, sqnorm, cand_ids, k):
    if cands.device.type != "cuda":
        raise ValueError(f"l2u8_topk_qbuf: unsupported device {cands.device}")
    if cands.dtype != torch.uint8 or q_pad.dtype != torch.uint8:
        raise TypeError(f"l2u8_topk_qbuf: q_pad {q_pad.dtype} and store {cands.dtype} must be "
                        "uint8")
    if sqnorm.dtype != torch.int32 or qbuf.dtype != torch.int32 or cand_ids.dtype != torch.int32:
        raise TypeError("l2u8_topk_qbuf: sqnorm, qbuf and cand_ids must be int32")
    for name, t in (("q_pad", q_pad), ("qbuf", qbuf), ("sqnorm", sqnorm),
                    ("cand_ids", cand_ids)):
        if t.device != cands.device:
            raise ValueError(f"l2u8_topk_qbuf: {name} on {t.device}, store on {cands.device}")
    b, c, d = cands.shape
    if q_pad.ndim != 2 or q_pad.shape[1] != d or q_pad.shape[0] < 1:
        raise ValueError(f"l2u8_topk_qbuf: q_pad {tuple(q_pad.shape)} vs store dim {d}")
    if (qbuf.ndim != 2 or qbuf.shape[0] != b or tuple(cand_ids.shape) != (b, c)
            or tuple(sqnorm.shape) != (b, c)):
        raise ValueError(f"l2u8_topk_qbuf: qbuf {tuple(qbuf.shape)} / sqnorm "
                         f"{tuple(sqnorm.shape)} / ids {tuple(cand_ids.shape)} vs store "
                         f"{tuple(cands.shape)}")
    if d % 64 or d > 256:
        raise ValueError(f"l2u8_topk_qbuf: width {d}; the kernel takes multiples of 64 up to 256")
    if k < 1:
        raise ValueError(f"l2u8_topk_qbuf: k={k}")
    return (q_pad.contiguous(), qbuf.contiguous(), cands.contiguous(), sqnorm.contiguous(),
            cand_ids.contiguous())


def l2u8_topk_qbuf(q_pad: torch.Tensor, qbuf: torch.Tensor, cands: torch.Tensor,
                   sqnorm: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """Exact top-k of every bucket's dispatched byte rows.

    q_pad    [R, d]     uint8 queries; row R-1 is the empty slots'
    qbuf     [B, S]     int32 query row per dispatch slot, R-1 = empty
    cands    [B, C, d]  uint8 partition rows
    sqnorm   [B, C]     int32 ||x||² of each row
    cand_ids [B, C]     int32 ids, < 0 = padding / hole

    Returns ([B, S, k] f32 ascending dists, exact integers, [B, S, k] int32
    ids), inf / -1 where fewer than k valid candidates exist; an earlier
    candidate wins an exact tie. On the card, empty slots come back as
    inf / -1 without being scanned.
    """
    global launches
    if cands.device.type == "cpu":
        return _ref.l2u8_topk_qbuf_ref(q_pad, qbuf, cands, sqnorm, cand_ids, k)
    q_pad, qbuf, cands, sqnorm, cand_ids = _check(q_pad, qbuf, cands, sqnorm, cand_ids, k)
    (b, c, d), s, lib = cands.shape, qbuf.shape[1], _lib()
    od = torch.empty((b, s, k), dtype=torch.float32, device=cands.device)
    oi = torch.empty((b, s, k), dtype=torch.int32, device=cands.device)
    with torch.cuda.device(cands.device):
        size = (ctypes.c_longlong * 4)()
        lib.l2u8_topk_qbuf_workspace(b, s, d, k, size)
        ws = torch.empty(max(size[0], 16), dtype=torch.uint8, device=cands.device)
        err = lib.l2u8_topk_qbuf(q_pad.data_ptr(), q_pad.shape[0], qbuf.data_ptr(), b, s,
                                 cands.data_ptr(), sqnorm.data_ptr(), cand_ids.data_ptr(), c, d,
                                 k, ws.data_ptr(), od.data_ptr(), oi.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"l2u8_topk_qbuf (S={s}, d={d}, k={k})")
    launches += 1
    return od, oi
