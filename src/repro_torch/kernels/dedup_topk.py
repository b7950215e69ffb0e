"""Wrapper of the CUDA replica-aware merge ``csrc/dedup_topk.cu``
(counterpart of ``repro/kernels/dedup_topk.py:dedup_topk``).

For a CPU tensor the wrapper runs the plain version (``ref.dedup_topk_ref``);
for a CUDA tensor it launches the kernel or raises — there is no fallback.
Unlike the TPU kernel, the pool needs no power-of-two padding, and invalid
means what the oracle says: id < 0 or a non-finite distance (the TPU kernel
also drops finite distances >= 1e30).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# kernel launches since the last reset (chip_smoke.py reads it to prove the
# serve path went through the kernel)
launches = 0


def _lib():
    lib = _build.load("dedup_topk")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dedup_topk.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
        lib.dedup_topk.restype = i32
        lib.dedup_topk_max_k.argtypes = []
        lib.dedup_topk_max_k.restype = i32
        lib._typed = True
    return lib


def dedup_topk(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """[Q, P] f32 dists × [Q, P] int32 ids → ([Q, k] ascending dists
    inf-padded, [Q, k] ids -1-padded), each id at most once per row with its
    smallest distance, ordered by (dist, id)."""
    global launches
    if dists.device.type == "cpu":
        return _ref.dedup_topk_ref(dists, ids, k)
    if dists.device.type != "cuda":
        raise ValueError(f"dedup_topk: unsupported device {dists.device}")
    if dists.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"dedup_topk: want float32 dists and int32 ids, got "
                        f"{dists.dtype} / {ids.dtype}")
    if ids.device != dists.device:
        raise ValueError(f"dedup_topk: ids on {ids.device}, dists on {dists.device}")
    if dists.ndim != 2 or ids.shape != dists.shape:
        raise ValueError(f"dedup_topk: dists {tuple(dists.shape)} vs ids {tuple(ids.shape)}")
    lib = _lib()
    if not 1 <= k <= lib.dedup_topk_max_k():
        raise ValueError(f"dedup_topk: k={k} outside [1, {lib.dedup_topk_max_k()}]")
    dists, ids = dists.contiguous(), ids.contiguous()
    q, p = dists.shape
    od = torch.empty((q, k), dtype=torch.float32, device=dists.device)
    oi = torch.empty((q, k), dtype=torch.int32, device=dists.device)
    with torch.cuda.device(dists.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dedup_topk(dists.data_ptr(), ids.data_ptr(), q, p, k,
                             od.data_ptr(), oi.data_ptr(), stream)
    _build.check(err, "dedup_topk")
    launches += 1
    return od, oi
