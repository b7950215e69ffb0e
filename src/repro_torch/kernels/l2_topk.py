"""Wrapper of the CUDA dispatch-buffer scan ``csrc/l2_topk_qbuf.cu``
(counterpart of ``repro/kernels/l2_topk.py:l2_topk_qbuf``).

For a CPU tensor the wrapper runs the plain version
(``ref.l2_topk_qbuf_ref``); for a CUDA tensor it launches the kernel or
raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# kernel launches since the last reset (chip_smoke.py reads it to prove the
# serve path went through the kernel)
launches = 0

_DTYPES = {torch.float32: "l2_topk_qbuf_f32", torch.bfloat16: "l2_topk_qbuf_bf16"}


def _lib():
    lib = _build.load("l2_topk_qbuf")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in _DTYPES.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
            f.restype = i32
        lib.l2_topk_qbuf_smem_bytes.argtypes = [i32, i32, i32]
        lib.l2_topk_qbuf_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def l2_topk_qbuf(q_pad: torch.Tensor, qbuf: torch.Tensor, cands: torch.Tensor,
                 cand_ids: torch.Tensor, k: int):
    """Top-k scan of every bucket's dispatched queries.

    q_pad    [R, d]     queries in the store dtype; row R-1 is the sentinel
    qbuf     [B, S]     int32 query row per dispatch slot, R-1 = empty
    cands    [B, C, d]  partition vectors (float32 or bfloat16)
    cand_ids [B, C]     int32 ids, < 0 = padding / hole

    Returns ([B, S, k] f32 ascending dists, [B, S, k] int32 ids), inf / -1
    where fewer than k valid candidates exist. On the card, empty slots come
    back as inf / -1 without being scanned; the plain version scans them
    against the sentinel row. Callers drop those slots either way.
    """
    global launches
    if cands.device.type == "cpu":
        return _ref.l2_topk_qbuf_ref(q_pad, qbuf, cands, cand_ids, k)
    if cands.device.type != "cuda":
        raise ValueError(f"l2_topk_qbuf: unsupported device {cands.device}")
    if cands.dtype not in _DTYPES:
        raise TypeError(f"l2_topk_qbuf: store dtype {cands.dtype} not in {list(_DTYPES)}")
    if q_pad.dtype != cands.dtype:
        raise TypeError(f"l2_topk_qbuf: q_pad is {q_pad.dtype}, store is {cands.dtype}")
    if qbuf.dtype != torch.int32 or cand_ids.dtype != torch.int32:
        raise TypeError("l2_topk_qbuf: qbuf and cand_ids must be int32")
    for name, t in (("q_pad", q_pad), ("qbuf", qbuf), ("cand_ids", cand_ids)):
        if t.device != cands.device:
            raise ValueError(f"l2_topk_qbuf: {name} on {t.device}, store on {cands.device}")
    b, c, d = cands.shape
    if q_pad.ndim != 2 or q_pad.shape[1] != d or q_pad.shape[0] < 1:
        raise ValueError(f"l2_topk_qbuf: q_pad {tuple(q_pad.shape)} vs store dim {d}")
    if qbuf.ndim != 2 or qbuf.shape[0] != b or tuple(cand_ids.shape) != (b, c):
        raise ValueError(f"l2_topk_qbuf: qbuf {tuple(qbuf.shape)} / ids "
                         f"{tuple(cand_ids.shape)} vs store {tuple(cands.shape)}")
    if k < 1:
        raise ValueError(f"l2_topk_qbuf: k={k}")
    q_pad, qbuf = q_pad.contiguous(), qbuf.contiguous()
    cands, cand_ids = cands.contiguous(), cand_ids.contiguous()
    s = qbuf.shape[1]
    lib = _lib()
    od = torch.empty((b, s, k), dtype=torch.float32, device=cands.device)
    oi = torch.empty((b, s, k), dtype=torch.int32, device=cands.device)
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _DTYPES[cands.dtype])(
            q_pad.data_ptr(), q_pad.shape[0], qbuf.data_ptr(), b, s,
            cands.data_ptr(), cand_ids.data_ptr(), c, d, k,
            od.data_ptr(), oi.data_ptr(), stream)
    if err:  # e.g. a block that needs more shared memory than it can opt into
        _build.check(err, f"l2_topk_qbuf (S={s}, d={d}, k={k}: "
                          f"{lib.l2_topk_qbuf_smem_bytes(s, d, k)} B of shared memory per block)")
    launches += 1
    return od, oi
