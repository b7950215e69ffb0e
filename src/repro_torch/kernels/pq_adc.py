"""Wrapper of the CUDA dispatch-buffer ADC scan ``csrc/pq_adc_topk_qbuf.cu``
(counterpart of ``repro/kernels/pq_adc.py:pq_adc_topk_qbuf``).

For a CPU tensor the wrapper runs the plain version
(``ref.pq_adc_topk_qbuf_ref``); for a CUDA tensor it launches the kernel or
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

# code plane dtype → entry point; codes are read in their store dtype
_CODES = {torch.uint8: "pq_adc_topk_qbuf_u8", torch.uint16: "pq_adc_topk_qbuf_u16"}


def _lib():
    lib = _build.load("pq_adc_topk_qbuf")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in _CODES.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, i32, i32, ptr, i32, i32, ptr, ptr, ptr, ptr, i32, i32,
                          ptr, ptr, ptr]
            f.restype = i32
        for fn in ("pq_adc_topk_qbuf_group", "pq_adc_topk_qbuf_smem_bytes"):
            getattr(lib, fn).argtypes = [i32, i32, i32, i32]
        lib.pq_adc_topk_qbuf_group.restype = i32
        lib.pq_adc_topk_qbuf_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def slots_per_block(lut_pad: torch.Tensor, codes: torch.Tensor, k: int) -> int:
    """Dispatch slots one block of the kernel takes at these widths."""
    _, m, ks = lut_pad.shape
    return _lib().pq_adc_topk_qbuf_group(m, ks, k, codes.element_size())


def pq_adc_topk_qbuf(lut_pad: torch.Tensor, qbuf: torch.Tensor, codes: torch.Tensor,
                     cand_ids: torch.Tensor, k: int, *, cand_off=None, q_off=None):
    """Top-k ADC scan of every bucket's dispatched queries.

    lut_pad  [R, m, ks] f32  per-query LUTs; row R-1 is the empty slot's
    qbuf     [B, S]     int32 query row per dispatch slot, R-1 = empty
    codes    [B, N, m]  uint8 or uint16 PQ codes, read in that dtype
    cand_ids [B, N]     int32 ids, < 0 = padding / hole
    cand_off [B, N] f32 per-candidate offset, or None (none added)
    q_off    [B, S] f32 per-slot offset, or None (none added)

    Returns ([B, S, k] f32 ascending dists, [B, S, k] int32 ids), inf / -1
    where fewer than k valid candidates exist. On the card, empty slots come
    back as inf / -1 without being scanned; the plain version scans them
    against the LUT row R-1. Callers drop those slots either way.
    """
    global launches
    if codes.device.type == "cpu":
        return _ref.pq_adc_topk_qbuf_ref(lut_pad, qbuf, codes, cand_ids, k,
                                         cand_off=cand_off, q_off=q_off)
    if codes.device.type != "cuda":
        raise ValueError(f"pq_adc_topk_qbuf: unsupported device {codes.device}")
    if codes.dtype not in _CODES:
        raise TypeError(f"pq_adc_topk_qbuf: code dtype {codes.dtype} not in {list(_CODES)}")
    if lut_pad.dtype != torch.float32:
        raise TypeError(f"pq_adc_topk_qbuf: lut_pad is {lut_pad.dtype}, not float32")
    if qbuf.dtype != torch.int32 or cand_ids.dtype != torch.int32:
        raise TypeError("pq_adc_topk_qbuf: qbuf and cand_ids must be int32")
    offsets = {"cand_off": cand_off, "q_off": q_off}
    for name, t in offsets.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"pq_adc_topk_qbuf: {name} is {t.dtype}, not float32")
    b, n, m = codes.shape
    if lut_pad.ndim != 3 or lut_pad.shape[1] != m or lut_pad.shape[0] < 1:
        raise ValueError(f"pq_adc_topk_qbuf: lut_pad {tuple(lut_pad.shape)} vs codes "
                         f"{tuple(codes.shape)}")
    if qbuf.ndim != 2 or qbuf.shape[0] != b or tuple(cand_ids.shape) != (b, n):
        raise ValueError(f"pq_adc_topk_qbuf: qbuf {tuple(qbuf.shape)} / ids "
                         f"{tuple(cand_ids.shape)} vs codes {tuple(codes.shape)}")
    s = qbuf.shape[1]
    want = {"cand_off": (b, n), "q_off": (b, s)}
    for name, t in offsets.items():
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"pq_adc_topk_qbuf: {name} {tuple(t.shape)}, want {want[name]}")
    for name, t in (("lut_pad", lut_pad), ("qbuf", qbuf), ("cand_ids", cand_ids),
                    *offsets.items()):
        if t is not None and t.device != codes.device:
            raise ValueError(f"pq_adc_topk_qbuf: {name} on {t.device}, codes on {codes.device}")
    if k < 1:
        raise ValueError(f"pq_adc_topk_qbuf: k={k}")
    lut_pad, qbuf, codes, cand_ids = (t.contiguous() for t in (lut_pad, qbuf, codes, cand_ids))
    cand_off, q_off = (None if t is None else t.contiguous() for t in (cand_off, q_off))
    ks = lut_pad.shape[2]
    lib = _lib()
    od = torch.empty((b, s, k), dtype=torch.float32, device=codes.device)
    oi = torch.empty((b, s, k), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _CODES[codes.dtype])(
            lut_pad.data_ptr(), lut_pad.shape[0], m, ks, qbuf.data_ptr(), b, s,
            codes.data_ptr(), cand_ids.data_ptr(),
            None if cand_off is None else cand_off.data_ptr(),
            None if q_off is None else q_off.data_ptr(), n, k,
            od.data_ptr(), oi.data_ptr(), stream)
    if err:  # e.g. one slot's LUT and list exceed the shared memory of a block
        _build.check(err, f"pq_adc_topk_qbuf (m={m}, ks={ks}, k={k}: "
                          f"{lib.pq_adc_topk_qbuf_smem_bytes(m, ks, k, codes.element_size())} "
                          f"B of shared memory per block)")
    launches += 1
    return od, oi
