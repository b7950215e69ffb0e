"""Per-partition scan of the serve step, f32 tier (counterpart of the f32
branch of ``repro/serving/scan.py``, ``:89-113``)."""
from __future__ import annotations

from repro_torch.kernels import ops as kops


def run(impl: str, qbuf, q_pad, vecs_loc, ids_loc, k: int):
    """Scan every partition's candidates for its dispatched queries.

    qbuf     [b_loc, q_cap] int32 — query row per slot, ``q_row`` = empty
    q_pad    [q_row + 1, d]       — queries + sentinel row for empty slots
    vecs_loc [b_loc, cap, d]      — partition vectors (store dtype)
    ids_loc  [b_loc, cap] int32   — point ids, -1 = padding / hole

    Returns ([b_loc, q_cap, k] dists, [b_loc, q_cap, k] ids); rows for empty
    slots are dropped by the serve step's scatter.
    """
    # cast the compact plane to the store dtype: the quantization point of
    # the reference (bf16 stores see bf16 queries, accumulated in f32)
    qp = q_pad.to(vecs_loc.dtype)
    return kops.l2_topk_qbuf(qp, qbuf, vecs_loc, ids_loc, k, impl=impl)
