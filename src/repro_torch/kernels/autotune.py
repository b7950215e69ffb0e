"""Measured sweep of the dispatch-buffer scans' one free launch parameter
(counterpart of ``repro/kernels/autotune.py``).

The reference sweeps its Pallas stream tile. The CUDA scans
``csrc/l2_topk_qbuf.cu`` and ``csrc/pq_adc_topk_qbuf.cu`` stream whole
candidate ranges and take no tile; what they leave free is G, the dispatch
slots a block (16 or 32 for the L2 scan, 1 to 8 for the ADC scan), which the
occupancy calculator picks when nobody names one. This module times each
candidate G on operands shaped like the store, caches the winner per store
shape — kernel, capacity, operand widths, k and the plane's itemsize (G's
shared memory, so whether it fits, depends on it); not the bucket or slot
counts, which change with every batch bucket — and keeps a record of every
sweep. A G whose block does not fit the shared memory a block can opt into
is recorded as refused, with the reason, and never launched. Every G a
sweep launches is held against the calculator's launch on the same
operands: ``same_bits`` in the record.

``lookup`` of a shape no sweep has seen returns None, which the ops
wrappers (``kernels/ops.py``) pass on as G = 0: the calculator's choice, the
launch that runs without this module. On the CPU there is no G: the
kernels' wrappers take their plain versions there, so a sweep times the
plain version once a candidate and the cache works as on the card.
"""
from __future__ import annotations

import statistics
import time

import torch

from repro_torch.utils.device import resolve_device

_CACHE: dict[tuple, int] = {}
_RECORDS: list[dict] = []

L2_GROUPS = (16, 32)
ADC_GROUPS = (1, 2, 3, 4, 5, 6, 7, 8)


def clear() -> None:
    """Drop every cached group and sweep record."""
    _CACHE.clear()
    _RECORDS.clear()


def records() -> list[dict]:
    """One dict a sweep call, in call order."""
    return list(_RECORDS)


def pq_adc_key(cap: int, m: int, ks: int, k: int, itemsize: int = 1) -> tuple:
    """The ADC scan's store shape; ``itemsize`` that of the codes."""
    return ("pq_adc_topk_qbuf", int(cap), int(m), int(ks), int(k), int(itemsize))


def l2_key(cap: int, d: int, k: int, itemsize: int = 4) -> tuple:
    """The L2 scan's store shape; ``itemsize`` that of the vector plane."""
    return ("l2_topk_qbuf", int(cap), int(d), int(k), int(itemsize))


def lookup(key: tuple, default: int | None = None) -> int | None:
    """The group cached for ``key``, else ``default`` (None: the occupancy
    calculator's choice)."""
    return _CACHE.get(key, default)


def _time_call(fn, device: torch.device, repeats: int = 5) -> float:
    """Median seconds of ``fn()`` after one untimed call: CUDA events on a
    card, the host clock elsewhere."""
    fn()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _sweep(key: tuple, run_one, candidates, refusal, device: torch.device) -> int:
    """Time ``run_one(g)`` for every candidate ``refusal(g)`` lets through
    (it returns None or the reason a group cannot launch), cache and record
    the fastest. ``run_one(0)`` is the calculator's launch."""
    if key in _CACHE:
        _RECORDS.append({"key": list(key), "cached": True, "group": _CACHE[key],
                         "timings_s": None, "refused": None, "same_bits": None})
        return _CACHE[key]
    base = run_one(0)
    timings, refused, same = {}, {}, {}
    for g in (int(c) for c in candidates):
        reason = refusal(g)
        if reason is not None:
            refused[str(g)] = reason
            continue
        same[str(g)] = _same(run_one(g), base)
        timings[str(g)] = _time_call(lambda: run_one(g), device)
    if not timings:
        raise ValueError(f"autotune {key}: no candidate group fits ({refused})")
    best = int(min(timings, key=timings.get))
    _CACHE[key] = best
    _RECORDS.append({"key": list(key), "cached": False, "group": best,
                     "timings_s": timings, "default_s": _time_call(lambda: run_one(0), device),
                     "refused": refused, "same_bits": same})
    return best


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def autotune_l2_qbuf(cap: int, d: int, k: int, *, dtype=torch.float32,
                     candidates=L2_GROUPS, b_loc: int = 4, q_cap: int = 8, q_row: int = 16,
                     seed: int = 0, device=None, operands=None) -> int:
    """Sweep G of ``l2_topk_qbuf`` for a store [b_loc, cap, d] of ``dtype``
    at depth ``k``: on synthetic operands (queries and vectors normal, every
    slot a query row or the empty row at random, ids with a tenth of them
    padding), or on ``operands`` = (q_pad, qbuf, cands, cand_ids) of that
    store shape. Returns the winning group and caches it."""
    from repro_torch.kernels import l2_topk as _l2

    dev = resolve_device(device if operands is None else operands[2].device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    key = l2_key(cap, d, k, itemsize)
    if key in _CACHE:
        return _sweep(key, None, candidates, None, dev)
    if operands is None:
        gen = _generator(dev, seed)
        q_pad = torch.randn((q_row + 1, d), generator=gen, device=dev).to(dtype)
        qbuf = torch.randint(0, q_row + 1, (b_loc, q_cap), generator=gen, device=dev,
                             dtype=torch.int32)
        cands = torch.randn((b_loc, cap, d), generator=gen, device=dev).to(dtype)
        cand_ids = torch.randint(0, 10 * cap, (b_loc, cap), generator=gen, device=dev,
                                 dtype=torch.int32)
        cand_ids[torch.rand((b_loc, cap), generator=gen, device=dev) < 0.1] = -1
    else:
        q_pad, qbuf, cands, cand_ids = operands
        if tuple(cands.shape[1:]) != (cap, d) or cands.dtype != dtype:
            raise ValueError(f"autotune_l2_qbuf: operands' store {tuple(cands.shape)} "
                             f"{cands.dtype}, not [*, {cap}, {d}] {dtype}")

    def refusal(g):
        if dev.type != "cuda":
            return None
        plan = _l2.group_plan(d, k, itemsize, g, dev)
        return None if plan["fits"] else (f"a block of {g} slots needs {plan['smem_bytes']} B "
                                          f"of shared memory, more than a block can opt into")

    def run_one(g):
        return _l2.l2_topk_qbuf(q_pad, qbuf, cands, cand_ids, k, group=g)

    return _sweep(key, run_one, candidates, refusal, dev)


def autotune_pq_adc_qbuf(cap: int, m: int, ks: int, k: int, *, candidates=ADC_GROUPS,
                         b_loc: int = 4, q_cap: int = 8, q_row: int = 16, seed: int = 0,
                         device=None, operands=None) -> int:
    """Sweep G of ``pq_adc_topk_qbuf`` for codes [b_loc, cap, m] of ``ks``
    codewords (uint8 up to 256, else uint16) at depth ``k``: on synthetic
    operands (normal LUTs, random codes, slots and ids, with residual
    offsets), or on ``operands`` = (lut_pad, qbuf, codes, cand_ids,
    cand_off, q_off) of that store shape. Returns the winning group and
    caches it."""
    from repro_torch.kernels import pq_adc as _adc

    code_dtype = torch.uint8 if ks <= 256 else torch.uint16
    dev = resolve_device(device if operands is None else operands[2].device)
    key = pq_adc_key(cap, m, ks, k, code_dtype.itemsize)
    if key in _CACHE:
        return _sweep(key, None, candidates, None, dev)
    if operands is None:
        gen = _generator(dev, seed)
        lut_pad = torch.randn((q_row + 1, m, ks), generator=gen, device=dev)
        qbuf = torch.randint(0, q_row + 1, (b_loc, q_cap), generator=gen, device=dev,
                             dtype=torch.int32)
        codes = torch.randint(0, ks, (b_loc, cap, m), generator=gen, device=dev).to(code_dtype)
        cand_ids = torch.randint(0, 10 * cap, (b_loc, cap), generator=gen, device=dev,
                                 dtype=torch.int32)
        cand_off = torch.randn((b_loc, cap), generator=gen, device=dev)
        q_off = torch.randn((b_loc, q_cap), generator=gen, device=dev)
    else:
        lut_pad, qbuf, codes, cand_ids, cand_off, q_off = operands
        if tuple(codes.shape[1:]) != (cap, m) or lut_pad.shape[2] != ks:
            raise ValueError(f"autotune_pq_adc_qbuf: operands' codes {tuple(codes.shape)}, "
                             f"LUTs {tuple(lut_pad.shape)}, not [*, {cap}, {m}] of {ks}")

    def refusal(g):
        if dev.type != "cuda":
            return None
        plan = _adc.group_plan(m, ks, k, codes.element_size(), g, dev)
        return None if plan["fits"] else (f"a block of {g} slots needs {plan['smem_bytes']} B "
                                          f"of shared memory, more than a block can opt into")

    def run_one(g):
        return _adc.pq_adc_topk_qbuf(lut_pad, qbuf, codes, cand_ids, k, cand_off=cand_off,
                                     q_off=q_off, group=g)

    return _sweep(key, run_one, candidates, refusal, dev)
