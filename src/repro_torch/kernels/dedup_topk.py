"""Wrapper of the CUDA replica-aware merge ``csrc/dedup_topk.cu``
(counterpart of ``repro/kernels/dedup_topk.py:dedup_topk``).

For a CPU tensor the wrapper runs the plain version (``ref.dedup_topk_ref``);
for a CUDA tensor it launches the kernel or raises — there is no fallback.
Unlike the TPU kernel, the pool needs no power-of-two padding, and invalid
means what the oracle says: id < 0 or a non-finite distance (the TPU kernel
also drops finite distances >= 1e30). Each row is taken whole into a hash
table keyed by id, which also counts its duplicate ids: in shared memory where
it fits, else in a workspace the wrapper allocates (``workspace_slots``).
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
        lib.dedup_topk.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
        lib.dedup_topk.restype = i32
        lib.dedup_topk_workspace.argtypes = [i32, i32, i32]
        lib.dedup_topk_workspace.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def workspace_slots(q: int, p: int, k: int) -> int:
    """8-byte slots of global memory a [q, p] pool at k needs for its hash
    tables on the current card: 0 where a row's table fits in shared memory."""
    return int(_lib().dedup_topk_workspace(q, p, k))


def dedup_topk(dists: torch.Tensor, ids: torch.Tensor, k: int, *, dups=None):
    """[Q, P] f32 dists × [Q, P] int32 ids → ([Q, k] ascending dists
    inf-padded, [Q, k] ids -1-padded), each id at most once per row with its
    smallest distance, ordered by (dist, id). Given ``dups`` (int64 [Q]),
    each row's slots with an id ≥ 0 less its distinct ids are written into
    it."""
    global launches
    if dists.device.type == "cpu":
        return _ref.dedup_topk_ref(dists, ids, k, dups=dups)
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
    if k < 1:
        raise ValueError(f"dedup_topk: k={k}")
    q, p = dists.shape
    if dups is not None:
        if (dups.dtype != torch.int64 or tuple(dups.shape) != (q,)
                or dups.device != dists.device or not dups.is_contiguous()):
            raise ValueError(f"dedup_topk: dups must be a contiguous int64 [{q}] tensor on "
                             f"{dists.device}")
    dists, ids = dists.contiguous(), ids.contiguous()
    od = torch.empty((q, k), dtype=torch.float32, device=dists.device)
    oi = torch.empty((q, k), dtype=torch.int32, device=dists.device)
    with torch.cuda.device(dists.device):
        slots = lib.dedup_topk_workspace(q, p, k)
        ws = torch.empty(slots, dtype=torch.int64, device=dists.device) if slots else None
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dedup_topk(dists.data_ptr(), ids.data_ptr(), q, p, k,
                             od.data_ptr(), oi.data_ptr(),
                             None if dups is None else dups.data_ptr(),
                             None if ws is None else ws.data_ptr(), stream)
    _build.check(err, "dedup_topk")
    launches += 1
    return od, oi
