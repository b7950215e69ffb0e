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
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in _DTYPES.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr,
                          ptr]
            f.restype = i32
        for fn in ("l2_topk_qbuf_group", "l2_topk_qbuf_smem_bytes", "l2_topk_qbuf_blocks_per_sm"):
            getattr(lib, fn).argtypes = [i32, i32, i32]
        lib.l2_topk_qbuf_group.restype = i32
        lib.l2_topk_qbuf_blocks_per_sm.restype = i32
        lib.l2_topk_qbuf_smem_bytes.restype = i64
        lib.l2_topk_qbuf_workspace.argtypes = [i32, i32, i32, i32, i32, i32,
                                               ctypes.POINTER(i64)]
        lib.l2_topk_qbuf_workspace.restype = None
        lib.l2_topk_qbuf_plan_group.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i64)]
        lib.l2_topk_qbuf_plan_group.restype = None
        lib.l2_topk_qbuf_plan.argtypes = [ptr, i32, i32, i32, ptr, i32, i32, i32, i32, ptr, ptr,
                                          ptr, ptr]
        lib.l2_topk_qbuf_plan.restype = i32
        lib._typed = True
    return lib


def occupancy(cands: torch.Tensor, k: int) -> dict:
    """The dispatch-buffer scan's launch shape for the store ``cands``
    [B, C, d] on the current device: dispatch slots a group, blocks resident
    on an SM (the scan launches that many for every SM), shared memory a
    block."""
    d, size = cands.shape[-1], cands.element_size()
    lib = _lib()
    with torch.cuda.device(cands.device):
        return {"slots_per_block": lib.l2_topk_qbuf_group(d, k, size),
                "blocks_per_sm": lib.l2_topk_qbuf_blocks_per_sm(d, k, size),
                "smem_bytes": lib.l2_topk_qbuf_smem_bytes(d, k, size)}


def group_plan(d: int, k: int, itemsize: int, group: int, device) -> dict:
    """The launch with ``group`` (16 or 32) dispatch slots a block at these
    widths on ``device``: ``fits`` (False when a block of that group exceeds
    the shared memory one can opt into), its shared memory a block and
    blocks resident on an SM."""
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        _lib().l2_topk_qbuf_plan_group(d, k, itemsize, group, out)
    return {"fits": out[0] == group, "smem_bytes": out[1], "blocks_per_sm": out[2]}


def _workspace(lib, b: int, s: int, d: int, k: int, size: int, group: int, device):
    """(uint8 workspace, byte offset of its items, items it holds, partial
    lists its pool holds) for one launch with ``group`` (0: the occupancy
    calculator's)."""
    out = (ctypes.c_longlong * 4)()
    lib.l2_topk_qbuf_workspace(b, s, d, k, size, group, out)
    return torch.empty(max(out[0], 16), dtype=torch.uint8, device=device), out[1], out[2], out[3]


def _check(q_pad, qbuf, cands, cand_ids, k):
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
    return q_pad.contiguous(), qbuf.contiguous(), cands.contiguous(), cand_ids.contiguous()


def _raise(lib, err, s, d, k, cands, group):
    # e.g. a block that needs more shared memory than it can opt into
    _build.check(err, f"l2_topk_qbuf (S={s}, d={d}, k={k}, group {group or 'chosen'}: "
                      f"{lib.l2_topk_qbuf_smem_bytes(d, k, cands.element_size())} B of "
                      f"shared memory per block at the chosen group)")


def plan(q_pad: torch.Tensor, qbuf: torch.Tensor, cands: torch.Tensor,
         cand_ids: torch.Tensor, k: int) -> dict:
    """The work items the dispatch-buffer scan makes of these inputs on the
    card (its count and plan kernels alone; not a launch of the scan):
    ``items`` [n, 8] int64 on the CPU, columns bucket, first occupied slot,
    rows, c_lo, c_hi, ranges of the group, first partial list (-1 unsplit),
    range; the total work (occupied slots x valid end, summed over buckets);
    the partial lists the pool holds and those the splits use; the split
    items; and the workspace's bytes, at the occupancy calculator's group."""
    q_pad, qbuf, cands, cand_ids = _check(q_pad, qbuf, cands, cand_ids, k)
    (b, c, d), s, lib = cands.shape, qbuf.shape[1], _lib()
    with torch.cuda.device(cands.device):
        ws, at, cap, pool = _workspace(lib, b, s, d, k, cands.element_size(), 0, cands.device)
        od = torch.empty((b, s, k), dtype=torch.float32, device=cands.device)
        oi = torch.empty((b, s, k), dtype=torch.int32, device=cands.device)
        err = lib.l2_topk_qbuf_plan(qbuf.data_ptr(), q_pad.shape[0], b, s, cand_ids.data_ptr(),
                                    c, d, k, cands.element_size(), ws.data_ptr(),
                                    od.data_ptr(), oi.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        _raise(lib, err, s, d, k, cands, 0)
    head = ws[:24].cpu()
    front, back = (int(v) for v in head[:8].view(torch.int32))
    items = ws[at:at + cap * 32].view(torch.int32).view(cap, 8).cpu().long()
    items = torch.cat([items[:front], items[cap - back:]])
    split = items[:, 5] > 1
    return {"items": items, "total_work": int(head[16:24].view(torch.int64)[0]),
            "pool_lists": pool, "partial_lists": int(items[split, 2].sum()),
            "split_items": int(split.sum()), "workspace_bytes": ws.numel()}


def l2_topk_qbuf(q_pad: torch.Tensor, qbuf: torch.Tensor, cands: torch.Tensor,
                 cand_ids: torch.Tensor, k: int, *, group: int = 0):
    """Top-k scan of every bucket's dispatched queries.

    q_pad    [R, d]     queries in the store dtype; row R-1 is the sentinel
    qbuf     [B, S]     int32 query row per dispatch slot, R-1 = empty
    cands    [B, C, d]  partition vectors (float32 or bfloat16)
    cand_ids [B, C]     int32 ids, < 0 = padding / hole

    Returns ([B, S, k] f32 ascending dists, [B, S, k] int32 ids), inf / -1
    where fewer than k valid candidates exist. On the card, empty slots come
    back as inf / -1 without being scanned; the plain version scans them
    against the sentinel row. Callers drop those slots either way.

    ``group``: dispatch slots a block, 16 or 32, or 0 for the occupancy
    calculator's choice; a group that does not fit a block is refused. The
    result does not depend on it.
    """
    global launches
    if cands.device.type == "cpu":
        return _ref.l2_topk_qbuf_ref(q_pad, qbuf, cands, cand_ids, k)
    q_pad, qbuf, cands, cand_ids = _check(q_pad, qbuf, cands, cand_ids, k)
    (b, c, d), s, lib = cands.shape, qbuf.shape[1], _lib()
    od = torch.empty((b, s, k), dtype=torch.float32, device=cands.device)
    oi = torch.empty((b, s, k), dtype=torch.int32, device=cands.device)
    with torch.cuda.device(cands.device):
        ws = _workspace(lib, b, s, d, k, cands.element_size(), group, cands.device)[0]
        err = getattr(lib, _DTYPES[cands.dtype])(
            q_pad.data_ptr(), q_pad.shape[0], qbuf.data_ptr(), b, s,
            cands.data_ptr(), cand_ids.data_ptr(), c, d, k, group, ws.data_ptr(),
            od.data_ptr(), oi.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        _raise(lib, err, s, d, k, cands, group)
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
        for fn in ("l2_topk_group", "l2_topk_smem_bytes", "l2_topk_blocks_per_sm"):
            getattr(lib, fn).argtypes = [i32, i32, i32]
        lib.l2_topk_group.restype = i32
        lib.l2_topk_blocks_per_sm.restype = i32
        lib.l2_topk_smem_bytes.restype = ctypes.c_longlong
        lib.l2_topk_splits.argtypes = [i32, i32, i32, i32, i32]
        lib.l2_topk_splits.restype = i32
        lib._typed = True
    return lib


def scan_splits(b: int, q: int, c: int, d: int, k: int, device) -> int:
    """Ranges of whole 256-candidate units the kernel splits each of b
    candidate sets of c rows into for q queries each, on ``device``
    (``l2_topk_splits`` in ``csrc/l2_topk.cu``)."""
    with torch.cuda.device(device):
        return _scan_lib().l2_topk_splits(b, q, c, d, k)


def scan_occupancy(cands: torch.Tensor, k: int) -> dict:
    """The flat and batched scans' launch shape at these widths on the
    current device: query rows a block, blocks resident on an SM, shared
    memory a scan block."""
    d, size = cands.shape[-1], cands.element_size()
    lib = _scan_lib()
    with torch.cuda.device(cands.device):
        return {"rows_per_block": lib.l2_topk_group(d, k, size),
                "blocks_per_sm": lib.l2_topk_blocks_per_sm(d, k, size),
                "smem_bytes": lib.l2_topk_smem_bytes(d, k, size)}


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
        _build.check(err, f"{what} (d={d}, k={k}: "
                          f"{lib.l2_topk_smem_bytes(d, k, cands.element_size())} B of shared "
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
