"""Int8 error-feedback gradient compression over the "pod" axis
(counterpart of ``repro/train/grad_compress.py``).

The cross-pod gradient reduction is quantized to int8 with one scale a
tensor, and the quantization residual is kept in an error-feedback buffer
that is added back at the next step. The reference runs it as a
``shard_map`` over the mesh in which every leaf is replicated; the port
carries it out rank by rank: each pod rank holds its own gradients and error
buffers, quantizes ``g + e``, keeps ``x - deq`` as its new buffer, and the
dequantized tensors are summed over the pod ranks in rank order and divided
by their count. Within a pod, reductions stay full precision.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import psum


def _quantize(x: torch.Tensor):
    """(q int8, scale f32 []): scale = max|x| / 127 (at least 1e-20 / 127),
    q = clip(round(x / scale), -127, 127), rounding half to even."""
    scale = torch.clamp(x.abs().max(), min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_pod(grads, err, mesh):
    """``grads`` and ``err``: one list of f32 tensors a pod rank (the same
    leaves in each), ``grads[p][i]`` rank ``p``'s gradient of leaf ``i``.
    Returns ``(reduced, new_err)``: ``reduced[i]`` the mean over the pod ranks
    of their dequantized ``g + e`` (one tensor, on the first rank's device),
    ``new_err[p][i]`` rank ``p``'s residual ``x - deq``. (The reference's
    call hands every pod rank one replicated tree: here ``[g] * npod``.)"""
    npod = mesh.shape["pod"]
    if len(grads) != npod or len(err) != npod:
        raise ValueError(f"{len(grads)} gradient and {len(err)} error lists for "
                         f"{npod} pod ranks")
    reduced, new_err = [], [[] for _ in range(npod)]

    def dequantized(i, p):
        x = grads[p][i].float() + err[p][i]               # error feedback
        q, scale = _quantize(x)
        deq = q.float() * scale
        new_err[p].append(x - deq)                        # carried to the next step
        return deq.to(grads[0][i].device)

    for i in range(len(grads[0])):
        reduced.append(psum(dequantized(i, p) for p in range(npod)) / npod)
    return reduced, new_err


def init_error_buffers(params) -> list:
    """Zero f32 buffers shaped as ``params``."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]


def compression_ratio_bytes(params) -> dict:
    """Bytes a step moves across pods: f32 against int8 plus one f32 scale a
    tensor."""
    params = list(params)
    n = sum(int(p.numel()) for p in params)
    return {"f32_bytes": 4 * n, "int8_bytes": n + 4 * len(params),
            "ratio": 4 * n / max(n, 1)}
