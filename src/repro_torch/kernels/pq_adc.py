"""Wrappers of the CUDA ADC kernels: the dispatch-buffer scan
``csrc/pq_adc_topk_qbuf.cu`` (counterpart of
``repro/kernels/pq_adc.py:pq_adc_topk_qbuf``), the full matrix
``csrc/pq_adc.cu`` (``pq_adc``) and the flat and batched scans
``csrc/pq_adc_topk.cu`` (``pq_adc_topk``, ``pq_adc_topk_batched``).

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

# code plane dtype → entry point; codes are read in their store dtype
_CODES = {torch.uint8: "pq_adc_topk_qbuf_u8", torch.uint16: "pq_adc_topk_qbuf_u16"}


def _lib():
    lib = _build.load("pq_adc_topk_qbuf")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in _CODES.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, i32, i32, ptr, i32, i32, ptr, ptr, ptr, ptr, i32, i32,
                          i32, ptr, ptr, ptr]
            f.restype = i32
        for fn in ("pq_adc_topk_qbuf_group", "pq_adc_topk_qbuf_smem_bytes",
                   "pq_adc_topk_qbuf_blocks_per_sm"):
            getattr(lib, fn).argtypes = [i32, i32, i32, i32]
        lib.pq_adc_topk_qbuf_group.restype = i32
        lib.pq_adc_topk_qbuf_blocks_per_sm.restype = i32
        lib.pq_adc_topk_qbuf_smem_bytes.restype = ctypes.c_longlong
        lib.pq_adc_topk_qbuf_plan_group.argtypes = [i32, i32, i32, i32, i32,
                                                    ctypes.POINTER(ctypes.c_longlong)]
        lib.pq_adc_topk_qbuf_plan_group.restype = None
        lib._typed = True
    return lib


def occupancy(lut_pad: torch.Tensor, codes: torch.Tensor, k: int) -> dict:
    """The kernel's launch shape at these widths on the current device: slots
    (warps) a block, blocks resident on an SM, shared memory a block."""
    _, m, ks = lut_pad.shape
    lib, size = _lib(), codes.element_size()
    with torch.cuda.device(codes.device):
        return {"slots_per_block": lib.pq_adc_topk_qbuf_group(m, ks, k, size),
                "blocks_per_sm": lib.pq_adc_topk_qbuf_blocks_per_sm(m, ks, k, size),
                "smem_bytes": lib.pq_adc_topk_qbuf_smem_bytes(m, ks, k, size)}


def group_plan(m: int, ks: int, k: int, code_size: int, group: int, device) -> dict:
    """The launch with ``group`` (1 to 8) dispatch slots a block at these
    widths on ``device``: ``fits`` (False when a block of that group exceeds
    the shared memory one can opt into), its shared memory a block and
    blocks resident on an SM."""
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        _lib().pq_adc_topk_qbuf_plan_group(m, ks, k, code_size, group, out)
    return {"fits": out[0] == group, "smem_bytes": out[1], "blocks_per_sm": out[2]}


def pq_adc_topk_qbuf(lut_pad: torch.Tensor, qbuf: torch.Tensor, codes: torch.Tensor,
                     cand_ids: torch.Tensor, k: int, *, cand_off=None, q_off=None,
                     group: int = 0):
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

    ``group``: dispatch slots a block, 1 to 8, or 0 for the occupancy
    calculator's choice; a group that does not fit a block is refused. The
    result does not depend on it.
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
            None if q_off is None else q_off.data_ptr(), n, k, group,
            od.data_ptr(), oi.data_ptr(), stream)
    if err:  # e.g. one slot's LUT and list exceed the shared memory of a block
        _build.check(err, f"pq_adc_topk_qbuf (m={m}, ks={ks}, k={k}, "
                          f"group {group or 'chosen'}: "
                          f"{lib.pq_adc_topk_qbuf_smem_bytes(m, ks, k, codes.element_size())} "
                          f"B of shared memory per block)")
    launches += 1
    return od, oi


# ---------------------------------------------------------------- full, flat and batched
# ``csrc/pq_adc.cu`` (counterpart of ``repro/kernels/pq_adc.py:pq_adc``) and
# ``csrc/pq_adc_topk.cu`` (``pq_adc_topk``, ``pq_adc_topk_batched``); each
# entry point counts its own launches. The full matrix and the flat top-k run
# on the body ``csrc/adc_tile.cuh``, the batched top-k on ``csrc/adc_scan.cuh``.

full_launches = 0
flat_launches = 0
batched_launches = 0

_FULL = {torch.uint8: "pq_adc_u8", torch.uint16: "pq_adc_u16"}
_FLAT = {torch.uint8: "pq_adc_topk_flat_u8", torch.uint16: "pq_adc_topk_flat_u16"}
_TOPK = {torch.uint8: "pq_adc_topk_u8", torch.uint16: "pq_adc_topk_u16"}
_PLAN = ("rows_per_block", "warps_per_block", "splits", "blocks_per_sm", "smem_bytes")


def _full_lib():
    lib = _build.load("pq_adc")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in _FULL.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, i32, i32, ptr, i32, ptr, ptr]
            f.restype = i32
        lib.pq_adc_plan.argtypes = [i32] * 5 + [ptr]
        lib.pq_adc_plan.restype = i32
        lib._typed = True
    return lib


def _topk_lib():
    lib = _build.load("pq_adc_topk")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in _TOPK.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr]
            f.restype = i32
        for fn in _FLAT.values():
            f = getattr(lib, fn)
            f.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr]
            f.restype = i32
        lib.pq_adc_topk_flat_scratch_bytes.argtypes = [i32, i32]
        lib.pq_adc_topk_flat_scratch_bytes.restype = ctypes.c_longlong
        lib.pq_adc_topk_smem_bytes.argtypes = [i32, i32, i32, i32]
        lib.pq_adc_topk_smem_bytes.restype = ctypes.c_longlong
        lib.pq_adc_topk_flat_plan.argtypes = [i32] * 6 + [ptr]
        lib.pq_adc_topk_flat_plan.restype = i32
        lib._typed = True
    return lib


def _plan(fn, what: str, *args) -> dict:
    out = (ctypes.c_longlong * len(_PLAN))()
    _build.check(fn(*args, ctypes.addressof(out)), what)
    return dict(zip(_PLAN, (int(v) for v in out)))


def full_plan(q: int, n: int, m: int, ks: int, code_size: int, device) -> dict:
    """``pq_adc``'s launch at these widths on ``device`` (``pq_adc_plan`` in
    ``csrc/pq_adc.cu``): query rows a block (0: refused), warps a block,
    candidate ranges, blocks resident on an SM, shared memory a block."""
    with torch.cuda.device(device):
        return _plan(_full_lib().pq_adc_plan, "pq_adc_plan", q, n, m, ks, code_size)


def flat_plan(q: int, n: int, m: int, ks: int, k: int, code_size: int, device) -> dict:
    """The flat ``pq_adc_topk``'s launch at these widths on ``device``
    (``pq_adc_topk_flat_plan`` in ``csrc/pq_adc_topk.cu``), as ``full_plan``."""
    with torch.cuda.device(device):
        return _plan(_topk_lib().pq_adc_topk_flat_plan, "pq_adc_topk_flat_plan", q, n, m, ks, k,
                     code_size)


def _check_codes(what: str, lut: torch.Tensor, codes: torch.Tensor, smem_bytes) -> None:
    """Device and dtype checks shared by the three entry points;
    ``smem_bytes(code_size)`` is the kernel's shared memory per block."""
    if codes.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {codes.device}")
    if lut.dtype != torch.float32:
        raise TypeError(f"{what}: lut is {lut.dtype}, not float32")
    if codes.dtype == torch.int32:  # ks > 65,536 (core/pq.code_dtype): no LUT row fits
        raise RuntimeError(f"{what}: int32 codes (ks={lut.shape[-1]}) would need "
                           f"{smem_bytes(4)} B of shared memory per block")
    if codes.dtype not in _FULL:
        raise TypeError(f"{what}: code dtype {codes.dtype} not in {list(_FULL)}")
    if lut.device != codes.device:
        raise ValueError(f"{what}: lut on {lut.device}, codes on {codes.device}")


def pq_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The full ADC matrix dist[q, n] = Σ_m lut[q, m, codes[n, m]], summed
    over m in order: lut [Q, m, ks] f32 × codes [N, m] uint8 or uint16 (read
    in that dtype) → [Q, N] f32."""
    global full_launches
    if codes.device.type == "cpu":
        return _ref.pq_adc_ref(lut, codes)

    def smem(size):
        return full_plan(lut.shape[0], codes.shape[0], lut.shape[-2], lut.shape[-1], size,
                         codes.device)["smem_bytes"]

    _check_codes("pq_adc", lut, codes, smem)
    if lut.ndim != 3 or codes.ndim != 2 or lut.shape[1] != codes.shape[1]:
        raise ValueError(f"pq_adc: lut {tuple(lut.shape)} vs codes {tuple(codes.shape)}")
    q, m, ks = lut.shape
    n = codes.shape[0]
    lut, codes = lut.contiguous(), codes.contiguous()
    lib = _full_lib()
    out = torch.empty((q, n), dtype=torch.float32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FULL[codes.dtype])(lut.data_ptr(), q, m, ks, codes.data_ptr(), n,
                                               out.data_ptr(), stream)
    if err:  # one row's LUT exceeds the shared memory of a block
        _build.check(err, f"pq_adc (m={m}, ks={ks}: {smem(codes.element_size())} B of "
                          f"shared memory per block, Q={q})")
    full_launches += 1
    return out


def _topk(lut, codes, cand_ids, k: int, cand_off, q_off, what: str, flat: bool):
    """Launch the ADC top-k over lut [B, Q, m, ks] × codes [B, N, m] (checked
    here): the flat scan (B = 1) or the batched one."""
    def smem(size):
        if flat:
            return flat_plan(lut.shape[1], codes.shape[1], lut.shape[-2], lut.shape[-1], k, size,
                             codes.device)["smem_bytes"]
        return _topk_lib().pq_adc_topk_smem_bytes(lut.shape[-2], lut.shape[-1], k, size)

    _check_codes(what, lut, codes, smem)
    if cand_ids.dtype != torch.int32:
        raise TypeError(f"{what}: cand_ids must be int32")
    offsets = {"cand_off": cand_off, "q_off": q_off}
    for name, t in offsets.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, not float32")
    b, n, m = codes.shape
    if lut.shape[0] != b or lut.shape[2] != m or tuple(cand_ids.shape) != (b, n):
        raise ValueError(f"{what}: lut {tuple(lut.shape)} / ids {tuple(cand_ids.shape)} vs "
                         f"codes {tuple(codes.shape)}")
    q, ks = lut.shape[1], lut.shape[3]
    want = {"cand_off": (b, n), "q_off": (b, q)}
    for name, t in offsets.items():
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"{what}: {name} {tuple(t.shape)}, want {want[name]}")
    for name, t in (("cand_ids", cand_ids), *offsets.items()):
        if t is not None and t.device != codes.device:
            raise ValueError(f"{what}: {name} on {t.device}, codes on {codes.device}")
    if k < 1:
        raise ValueError(f"{what}: k={k}")
    lut, codes, cand_ids = lut.contiguous(), codes.contiguous(), cand_ids.contiguous()
    cand_off, q_off = (None if t is None else t.contiguous() for t in (cand_off, q_off))
    lib = _topk_lib()
    od = torch.empty((b, q, k), dtype=torch.float32, device=codes.device)
    oi = torch.empty((b, q, k), dtype=torch.int32, device=codes.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = (codes.data_ptr(), cand_ids.data_ptr(), ptr(cand_off), ptr(q_off), n, k)
        if flat:  # each row's bound and running list, kept in device memory
            scratch = torch.empty(lib.pq_adc_topk_flat_scratch_bytes(q, k), dtype=torch.uint8,
                                  device=codes.device)
            err = getattr(lib, _FLAT[codes.dtype])(lut.data_ptr(), q, m, ks, *head,
                                                   scratch.data_ptr(), od.data_ptr(),
                                                   oi.data_ptr(), stream)
        else:
            err = getattr(lib, _TOPK[codes.dtype])(lut.data_ptr(), b, q, m, ks, *head,
                                                   od.data_ptr(), oi.data_ptr(), stream)
    if err:  # e.g. one row's LUT and list exceed the shared memory of a block
        _build.check(err, f"{what} (m={m}, ks={ks}, k={k}: {smem(codes.element_size())} B of "
                          f"shared memory per block)")
    return od, oi


def pq_adc_topk(lut: torch.Tensor, codes: torch.Tensor, cand_ids: torch.Tensor, k: int, *,
                cand_off=None, q_off=None):
    """Fused ADC scan and top-k of one query set over one code set.

    lut [Q, m, ks] f32, codes [N, m] uint8 or uint16, cand_ids [N] int32
    (< 0 = padding), cand_off [N] / q_off [Q] f32 or None (none added) →
    ([Q, k] f32 ascending dists, [Q, k] int32 ids), inf / -1 where fewer
    than k valid candidates exist; an earlier candidate wins an exact tie.
    """
    global flat_launches
    if codes.device.type == "cpu":
        return _ref.pq_adc_topk_ref(lut, codes, cand_ids, k, cand_off=cand_off, q_off=q_off)
    if lut.ndim != 3 or codes.ndim != 2 or cand_ids.ndim != 1:
        raise ValueError(f"pq_adc_topk: lut {tuple(lut.shape)}, codes {tuple(codes.shape)}, "
                         f"ids {tuple(cand_ids.shape)}")
    od, oi = _topk(lut[None], codes[None], cand_ids[None], k,
                   None if cand_off is None else cand_off[None],
                   None if q_off is None else q_off[None], "pq_adc_topk", True)
    flat_launches += 1
    return od[0], oi[0]


def pq_adc_topk_batched(lut: torch.Tensor, codes: torch.Tensor, cand_ids: torch.Tensor,
                        k: int, *, cand_off=None, q_off=None):
    """``pq_adc_topk`` for each bucket b: lut [B, Q, m, ks] against codes
    [B, N, m] with cand_ids [B, N], cand_off [B, N] and q_off [B, Q] →
    ([B, Q, k], [B, Q, k]). Every query row is scanned, the last one too."""
    global batched_launches
    if codes.device.type == "cpu":
        return _ref.pq_adc_topk_batched_ref(lut, codes, cand_ids, k, cand_off=cand_off,
                                            q_off=q_off)
    if lut.ndim != 4 or codes.ndim != 3:
        raise ValueError(f"pq_adc_topk_batched: lut {tuple(lut.shape)}, codes "
                         f"{tuple(codes.shape)}")
    od, oi = _topk(lut, codes, cand_ids, k, cand_off, q_off, "pq_adc_topk_batched", False)
    batched_launches += 1
    return od, oi
