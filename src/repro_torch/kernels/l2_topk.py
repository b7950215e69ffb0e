"""Wrappers of the CUDA L2 scans: the dispatch-buffer scan
``csrc/l2_topk_qbuf.cu`` (counterpart of
``repro/kernels/l2_topk.py:l2_topk_qbuf``) and the flat and batched scans
``csrc/l2_topk.cu`` (``l2_topk``, ``l2_topk_batched``).

For a CPU tensor each wrapper runs its plain version (``ref.py``); for a
CUDA tensor it launches the kernel or raises — there is no fallback.
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


# ---------------------------------------------------------------- flat and batched
# ``csrc/l2_topk.cu`` (counterparts of ``repro/kernels/l2_topk.py:l2_topk`` and
# ``:l2_topk_batched``); each entry point counts its own launches

flat_launches = 0
batched_launches = 0

_SCAN = {torch.float32: "l2_topk_f32", torch.bfloat16: "l2_topk_bf16"}


def _scan_lib():
    lib = _build.load("l2_topk")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in _SCAN.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
            f.restype = i32
        lib.l2_topk_smem_bytes.argtypes = [i32, i32]
        lib.l2_topk_smem_bytes.restype = ctypes.c_longlong
        lib.l2_topk_splits.argtypes = [i32, i32, i32, i32, i32]
        lib.l2_topk_splits.restype = i32
        lib._typed = True
    return lib


def scan_splits(b: int, q: int, c: int, d: int, k: int, device) -> int:
    """Ranges of whole candidate tiles the kernel splits each of b candidate
    sets of c rows into for q queries each, on ``device``
    (``l2_topk_splits`` in ``csrc/l2_topk.cu``)."""
    with torch.cuda.device(device):
        return _scan_lib().l2_topk_splits(b, q, c, d, k)


def _scan(q, cands, cand_ids, k: int, what: str):
    """Launch the scan over q [B, Q, d] × cands [B, C, d] (checked here)."""
    if cands.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {cands.device}")
    if cands.dtype not in _SCAN:
        raise TypeError(f"{what}: dtype {cands.dtype} not in {list(_SCAN)}")
    if q.dtype != cands.dtype:
        raise TypeError(f"{what}: queries are {q.dtype}, candidates {cands.dtype}")
    if cand_ids.dtype != torch.int32:
        raise TypeError(f"{what}: cand_ids must be int32")
    for name, t in (("q", q), ("cand_ids", cand_ids)):
        if t.device != cands.device:
            raise ValueError(f"{what}: {name} on {t.device}, candidates on {cands.device}")
    b, c, d = cands.shape
    if q.shape[0] != b or q.shape[2] != d or tuple(cand_ids.shape) != (b, c):
        raise ValueError(f"{what}: queries {tuple(q.shape)} / ids {tuple(cand_ids.shape)} vs "
                         f"candidates {tuple(cands.shape)}")
    if k < 1:
        raise ValueError(f"{what}: k={k}")
    q, cands, cand_ids = q.contiguous(), cands.contiguous(), cand_ids.contiguous()
    nq = q.shape[1]
    lib = _scan_lib()
    splits = scan_splits(b, nq, c, d, k, cands.device)
    od = torch.empty((b, nq, k), dtype=torch.float32, device=cands.device)
    oi = torch.empty((b, nq, k), dtype=torch.int32, device=cands.device)
    pd = pc = None
    if splits > 1:  # the partial lists of each candidate range
        pd = torch.empty((b, splits, nq, k), dtype=torch.float32, device=cands.device)
        pc = torch.empty((b, splits, nq, k), dtype=torch.int32, device=cands.device)
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _SCAN[cands.dtype])(
            q.data_ptr(), b, nq, cands.data_ptr(), cand_ids.data_ptr(), c, d, k, splits,
            None if pd is None else pd.data_ptr(), None if pc is None else pc.data_ptr(),
            od.data_ptr(), oi.data_ptr(), stream)
    if err:
        _build.check(err, f"{what} (d={d}, k={k}: {lib.l2_topk_smem_bytes(d, k)} B of shared "
                          f"memory per block, {splits} splits)")
    return od, oi


def l2_topk(q: torch.Tensor, cands: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """Exact top-k of one query set against one candidate set.

    q [Q, d], cands [C, d] (float32 or bfloat16, both alike), cand_ids [C]
    int32 (< 0 = padding) → ([Q, k] f32 ascending dists, [Q, k] int32 ids),
    inf / -1 where fewer than k valid candidates exist; an earlier candidate
    wins an exact tie. Any Q and C.
    """
    global flat_launches
    if cands.device.type == "cpu":
        return _ref.l2_topk_ref(q, cands, cand_ids, k)
    if q.ndim != 2 or cands.ndim != 2 or cand_ids.ndim != 1:
        raise ValueError(f"l2_topk: q {tuple(q.shape)}, cands {tuple(cands.shape)}, ids "
                         f"{tuple(cand_ids.shape)}")
    od, oi = _scan(q[None], cands[None], cand_ids[None], k, "l2_topk")
    flat_launches += 1
    return od[0], oi[0]


def l2_topk_batched(q: torch.Tensor, cands: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """``l2_topk`` for each bucket b: q [B, Q, d] against cands [B, C, d] with
    cand_ids [B, C] → ([B, Q, k], [B, Q, k]). Every query row is scanned."""
    global batched_launches
    if cands.device.type == "cpu":
        return _ref.l2_topk_batched_ref(q, cands, cand_ids, k)
    if q.ndim != 3 or cands.ndim != 3:
        raise ValueError(f"l2_topk_batched: q {tuple(q.shape)}, cands {tuple(cands.shape)}")
    od, oi = _scan(q, cands, cand_ids, k, "l2_topk_batched")
    batched_launches += 1
    return od, oi
