"""Wrapper of the CUDA k-means assignment ``csrc/kmeans_assign.cu``
(counterpart of ``repro/kernels/kmeans_assign.py:kmeans_assign``).

For a CPU tensor the wrapper runs the plain version
(``ref.kmeans_assign_ref``); for a CUDA tensor it launches the kernel or
raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# kernel launches since the last reset (chip_smoke.py reads it to prove the
# k-means fit went through the kernel)
launches = 0

_DTYPES = {torch.float32: "kmeans_assign_f32", torch.bfloat16: "kmeans_assign_bf16"}


def _lib():
    lib = _build.load("kmeans_assign")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in _DTYPES.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr, ptr, ptr]
            f.restype = i32
        lib._typed = True
    return lib


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid of every point.

    x         [N, d]  points (float32 or bfloat16)
    centroids [B, d]  centroids, in x's dtype; B >= 1

    Returns (assign [N] int32, min d2 [N] f32): the squared L2 distance to
    the nearest centroid by the expansion ||x||² − 2x·c + ||c||² in f32, and
    its index; the lowest index wins an exact tie. Any N, B and d.
    """
    global launches
    if x.device.type == "cpu":
        return _ref.kmeans_assign_ref(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kmeans_assign: dtype {x.dtype} not in {list(_DTYPES)}")
    if centroids.dtype != x.dtype:
        raise TypeError(f"kmeans_assign: centroids are {centroids.dtype}, points {x.dtype}")
    if centroids.device != x.device:
        raise ValueError(f"kmeans_assign: centroids on {centroids.device}, points on {x.device}")
    if x.ndim != 2 or centroids.ndim != 2 or centroids.shape[1] != x.shape[1]:
        raise ValueError(f"kmeans_assign: x {tuple(x.shape)} vs centroids "
                         f"{tuple(centroids.shape)}")
    if centroids.shape[0] < 1:
        raise ValueError("kmeans_assign: no centroids")
    x, centroids = x.contiguous(), centroids.contiguous()
    (n, d), b = x.shape, centroids.shape[0]
    csq = torch.empty(b, dtype=torch.float32, device=x.device)
    oa = torch.empty(n, dtype=torch.int32, device=x.device)
    od = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), _DTYPES[x.dtype])(x.data_ptr(), n, centroids.data_ptr(), b, d,
                                                 csq.data_ptr(), oa.data_ptr(), od.data_ptr(),
                                                 stream)
    _build.check(err, f"kmeans_assign (N={n}, B={b}, d={d})")
    launches += 1
    return oa, od
