#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LIRA on one NVIDIA card, end to end.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device  — the card's name and power limit, torch and CUDA versions;
  2. build   — nvcc compiles every kernel under src/repro_torch/csrc/, all at once;
  3. edges   — each kernel against its plain PyTorch version on the card, at
               repro_torch.testing's edge cases (padding ids, k > pool,
               duplicate ids, exact ties, non-finite distances, bf16 store,
               residual offsets, uint16 codes, empty slots, buckets and rows
               with nothing valid, ties across the flat scan's candidate
               ranges, ragged N and B, B = 1, d not a multiple of 4,
               duplicate centroids) at the main paths' widths, under the same
               rule the tests use;
  4. main    — one engine at the lira-ann-q widths (dim 128, B = 1024
               partitions, k = 100, nprobe_max = 64, tier residual_pq with
               m = 16, ks = 256, rerank 4) over 1,000,000 base points and
               10,000 queries (SIFT1M's scale), built on the card. Its store
               keeps the f32 vectors, so it serves two paths, each as 10
               batches of 1,000 through search() with every kernel's launch
               counter zeroed just before and read just after:
                 f32         — recall@100 against exact ground truth (≥ 0.9);
                 residual_pq — recall@100 at lira-ann-q's rerank 4 (≥ 0.85),
                               and again at rerank 16, where it must be
                               ≥ 0.9 and within 0.03 of the f32 path's;
               then one batch per path served again with impl="ref" must
               agree, and one batch per path is profiled;
  5. pq      — a second engine with tier pq at 100,000 base points (same
               widths): launches, recall@100 against its own f32 tier, and
               cuda vs ref;
  6. kernels — each kernel against its plain version on the inputs the main
               paths gave it, timed with CUDA events beside its bound;
  7. kmeans  — the build's k-means over the 1M base (B = 1024, 20 Lloyd
               iterations from one k-means++ start): two plain fits must be
               equal bit for bit, a fit through kmeans_assign (21 launches)
               must reach the plain inertia within 1e-3, and one assignment
               pass at its centroids is held kernel vs plain (near-ties
               counted) and timed over the base and over 10M points made on
               the card;
  8. flat    — l2_topk of the first 1,000 queries over the whole base at
               k = 100, held against its plain version and against exact
               ground truth (up to ties at the 100th place), timed;
  9. batched — l2_topk_batched of the f32 path's first dispatch buffer
               expanded to [1024, 128, 128] against the store, held against
               its plain version and, on the occupied slots, against
               l2_topk_qbuf; timed.
Phases 7-9 zero their kernel's launch counter just before the path and read
it just after. Every matmul runs in full f32 (TF32 off for matmul and cuDNN),
so the plain versions are exact oracles.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_BASE, N_PQ_BASE, N_QUERIES, BATCH = 1_000_000, 100_000, 10_000, 1_000
# lira-ann-q (configs/lira_ann.py:CONFIG_QUANTIZED) as a build recipe
MAIN_BUILD = dict(n_partitions=1024, k=100, nprobe_max=64, eta=0.03, sigma=0.5,
                  train_frac=0.1, pq_m=16, pq_ks=256, rerank=4)
HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,           # CUDA-core f32 (no tensor cores)
            "bfloat16": 989e12}         # dense bf16 tensor-core rate


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- comparison
# the rule and the edge cases are repro_torch.testing's, which the tests share

def compare_l2(what, q_pad, qbuf, cands, cand_ids, k, *, exact_ids=False) -> float:
    """Kernel vs plain version on the occupied slots."""
    import torch

    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops

    d_k, i_k = kops.l2_topk_qbuf(q_pad, qbuf, cands, cand_ids, k, impl="cuda")
    d_p, i_p = kops.l2_topk_qbuf(q_pad, qbuf, cands, cand_ids, k, impl="ref")
    occ = rt.occupied(q_pad, qbuf)
    # on the card empty slots are skipped; the plain version (also what the
    # wrapper runs for CPU tensors) scans them against the sentinel row
    if not (bool(torch.isinf(d_k[~occ]).all()) and bool((i_k[~occ] == -1).all())):
        raise AssertionError(f"{what}: empty slots not flushed as inf / -1")
    return rt.assert_topk_match(d_k[occ], i_k[occ], d_p[occ], i_p[occ],
                                rt.qbuf_atol(q_pad, qbuf, cands, cand_ids),
                                exact_ids=exact_ids, what=what)


def compare_adc(what, lut_pad, qbuf, codes, cand_ids, k, cand_off, q_off) -> float:
    """Kernel vs plain version on the occupied slots: the kernel adds in the
    plain version's order, so distances and ids must be equal."""
    import torch

    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops

    args = (lut_pad, qbuf, codes, cand_ids, k)
    d_k, i_k = kops.pq_adc_topk_qbuf(*args, cand_off=cand_off, q_off=q_off, impl="cuda")
    d_p, i_p = kops.pq_adc_topk_qbuf(*args, cand_off=cand_off, q_off=q_off, impl="ref")
    occ = rt.occupied(lut_pad, qbuf)
    if not (bool(torch.isinf(d_k[~occ]).all()) and bool((i_k[~occ] == -1).all())):
        raise AssertionError(f"{what}: empty slots not flushed as inf / -1")
    return rt.assert_topk_match(d_k[occ], i_k[occ], d_p[occ], i_p[occ], 0.0, exact_ids=True,
                                what=what)


def compare_dedup(what, dists, ids, k) -> float:
    """Kernel vs plain version: no arithmetic, so equal element for element."""
    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops

    d_k, i_k = kops.dedup_topk(dists, ids, k, impl="cuda")
    d_p, i_p = kops.dedup_topk(dists, ids, k, impl="ref")
    return rt.assert_topk_match(d_k, i_k, d_p, i_p, 0.0, exact_ids=True, what=what)


def compare_assign(what, x, c, *, exact=False):
    """Kernel vs plain version under ``assert_assign_match``; returns (max abs
    error, points assigned differently: near-ties)."""
    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops

    ka, kd = kops.kmeans_assign(x, c, impl="cuda")
    pa, pd = kops.kmeans_assign(x, c, impl="ref")
    return rt.assert_assign_match(ka, kd, pa, pd, x, c, exact=exact, what=what)


def compare_scan(what, q, cands, ids, k, *, batched, exact_ids=False) -> float:
    """Flat or batched scan, kernel vs plain version, under ``l2_atol``."""
    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops

    fn = kops.l2_topk_batched if batched else kops.l2_topk
    d_k, i_k = fn(q, cands, ids, k, impl="cuda")
    d_p, i_p = fn(q, cands, ids, k, impl="ref")
    return rt.assert_topk_match(d_k, i_k, d_p, i_p, rt.l2_atol(q.reshape(-1, q.shape[-1]),
                                                              cands, ids),
                                exact_ids=exact_ids, what=what)


def edge_cases(dev) -> None:
    """Each kernel against its plain version at every edge case, at the main
    paths' widths (d = 128, k = 100; merge rows of 102,400 entries; ADC with
    m = 16, ks = 256, k = 400)."""
    import torch

    from repro_torch import testing as rt

    for case in rt.L2_CASES:
        arrays, k, dtype, exact = rt.l2_case(case, width="main")
        q_pad, qbuf, cands, ids = (torch.from_numpy(a).to(dev) for a in arrays)
        tdt = getattr(torch, dtype)
        err = compare_l2(case, q_pad.to(tdt), qbuf, cands.to(tdt), ids, k, exact_ids=exact)
        log(f"edges  l2_topk_qbuf  {case}: ok{', ids equal' if exact else ''} "
            f"(max abs err {err:.3g})")
    for case in rt.DEDUP_CASES:
        arrays, k = rt.dedup_case(case, width="main")
        compare_dedup(case, *(torch.from_numpy(a).to(dev) for a in arrays), k)
        log(f"edges  dedup_topk  {case}: ok, equal")
    for case in rt.ADC_CASES:
        (lut_pad, qbuf, codes, ids, coff, qoff), k, _ = rt.adc_case(case, width="main")
        lut_pad, qbuf, codes, ids = (torch.from_numpy(a).to(dev)
                                     for a in (lut_pad, qbuf, codes, ids))
        coff, qoff = (None if a is None else torch.from_numpy(a).to(dev) for a in (coff, qoff))
        compare_adc(case, lut_pad, qbuf, codes, ids, k, coff, qoff)
        log(f"edges  pq_adc_topk_qbuf  {case}: ok, equal ({codes.dtype}, "
            f"S {qbuf.shape[1]}, N {codes.shape[1]}, k {k})")
    for case in rt.KMEANS_CASES:
        (x, c), dtype, exact = rt.kmeans_case(case, width="main")
        x, c = (torch.from_numpy(a).to(dev).to(getattr(torch, dtype)) for a in (x, c))
        err, ties = compare_assign(case, x, c, exact=exact)
        log(f"edges  kmeans_assign  {case}: ok{', equal' if exact else ''} (N {x.shape[0]}, "
            f"B {c.shape[0]}, d {x.shape[1]}, {dtype}; max abs err {err:.3g}, "
            f"{ties} near-ties assigned differently)")
    for case in rt.L2_SCAN_CASES:
        (q, cands, ids), k, dtype, exact = rt.l2_scan_case(case, width="main")
        tdt = getattr(torch, dtype)
        q, cands = (torch.from_numpy(a).to(dev).to(tdt) for a in (q, cands))
        ids = torch.from_numpy(ids).to(dev)
        e1 = compare_scan(case, q[0], cands[0], ids[0], k, batched=False, exact_ids=exact)
        e2 = compare_scan(case, q, cands, ids, k, batched=True, exact_ids=exact)
        log(f"edges  l2_topk / l2_topk_batched  {case}: ok{', ids equal' if exact else ''} "
            f"(B {q.shape[0]}, Q {q.shape[1]}, C {cands.shape[1]}, k {k}; max abs err "
            f"{max(e1, e2):.3g})")


# ---------------------------------------------------------------- timing

def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def l2_bound(q_pad, qbuf, cands, cand_ids, k):
    """Least time for this run's scan: each input read once (the query
    plane, qbuf, and the ids and valid vectors of every partition that has an
    occupied slot), each output written once; 2·d flops per (occupied slot,
    valid candidate)."""
    from repro_torch import testing as rt

    occ = rt.occupied(q_pad, qbuf).sum(1).double()
    valid = (cand_ids >= 0).sum(1).double()
    item = cands.element_size()
    d = cands.shape[2]
    used = occ > 0
    nbytes = (q_pad.numel() * q_pad.element_size() + qbuf.numel() * 4
              + float((valid[used] * d * item).sum()) + int(used.sum()) * cand_ids.shape[1] * 4
              + qbuf.numel() * k * 8)
    ops = float((occ * valid).sum()) * 2 * d
    peak = PEAK_OPS["bfloat16" if item == 2 else "float32"]
    return nbytes, ops, peak


def adc_bound(lut_pad, qbuf, codes, cand_ids, k, cand_off, q_off):
    """Least time for this run's ADC scan: each input read once (the LUT rows
    the occupied slots name, qbuf and q_off, and of every bucket with an
    occupied slot its ids and cand_off and its valid candidates' codes), each
    output written once; m − 1 additions plus one per offset for each
    (occupied slot, valid candidate), at the f32 rate."""
    import torch

    from repro_torch import testing as rt

    occ_mask = rt.occupied(lut_pad, qbuf)
    occ = occ_mask.sum(1).double()
    valid = (cand_ids >= 0).sum(1).double()
    used = occ > 0
    _, m, ks = lut_pad.shape
    n = codes.shape[1]
    rows = torch.unique(qbuf[occ_mask]).numel()
    nbytes = (rows * m * ks * 4 + qbuf.numel() * 4 * (1 + (q_off is not None))
              + int(used.sum()) * n * 4 * (1 + (cand_off is not None))
              + float(valid[used].sum()) * m * codes.element_size()
              + qbuf.numel() * k * 8)
    ops = float((occ * valid).sum()) * (m - 1 + (q_off is not None) + (cand_off is not None))
    return nbytes, ops, PEAK_OPS["float32"]


def scan_bound(q, cands, cand_ids, k):
    """Least time for a batched scan (the flat one is one set): each input
    read once (every query row, every id, the valid candidates), each output
    written once; 2·d flops per (query row, valid candidate of its set)."""
    valid = float((cand_ids >= 0).sum())
    item = cands.element_size()
    d, nq = cands.shape[-1], q.shape[-2]
    nbytes = (q.numel() * q.element_size() + valid * d * item + cand_ids.numel() * 4
              + q.shape[:-1].numel() * k * 8)
    return nbytes, valid * nq * 2 * d, PEAK_OPS["bfloat16" if item == 2 else "float32"]


def assign_bound(x, c):
    """Least time for one assignment pass: x and the centroids read once, the
    assignment and its distance written once; 2·d flops per (point,
    centroid)."""
    nbytes = (x.numel() + c.numel()) * x.element_size() + x.shape[0] * 8
    return nbytes, 2.0 * x.shape[0] * c.shape[0] * x.shape[1], PEAK_OPS["float32"]


def bound_entry(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_batch(eng, queries, what, **search_kw) -> None:
    """One served batch under torch.profiler: device time by operation, and
    the device's busy share of the batch's wall time (the profiler's own
    host overhead lengthens the wall time, so the share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.search(queries, **search_kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        eng.search(queries, **search_kw)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op also reports its kernels' time
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    if not ops:
        log(f"profile {what}: torch.profiler saw no device time: not measured")
        return
    log(f"profile {what}: one batch of {len(queries)}: wall {wall_ms:.2f} ms under the "
        f"profiler, device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"profile   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:100]}")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bound, shapes):
    """One kernel's line of the kernels JSON; no single PyTorch call computes
    any of these functions, so ``library_ms`` is null."""
    bound_ms, bound_by = bound
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shapes": shapes}


# ---------------------------------------------------------------- k-means and exact scans

def kmeans_phase(dev, base, n_big: int):
    """The build's k-means at the main widths (B = 1024 over the base, 20
    Lloyd iterations, as LiraEngine.build runs it): two plain fits from one
    k-means++ start must repeat their bits; a fit through the kernel, its
    launches counted, must reach the plain fit's inertia within 1e-3; at its
    centroids one assignment pass is held kernel vs plain and timed, over the
    base and over ``n_big`` points made on the card. Returns the kernel's
    JSON entry."""
    import torch

    from repro_torch.core import kmeans as km
    from repro_torch.kernels import kmeans_assign as km_mod
    from repro_torch.kernels import ops as kops

    n_clusters, iters = MAIN_BUILD["n_partitions"], 20
    x = torch.as_tensor(base, device=dev)
    t0 = time.perf_counter()
    init = km.plus_plus_init(x, n_clusters, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"kmeans k-means++ over {tuple(x.shape)} to B = {n_clusters} in "
        f"{time.perf_counter() - t0:.1f} s")
    fits = []
    for _ in range(2):
        t0 = time.perf_counter()
        fits.append(km.lloyd(x, init, iters))
        torch.cuda.synchronize()
        log(f"kmeans plain Lloyd, {iters} iterations: {time.perf_counter() - t0:.2f} s, "
            f"inertia {float(fits[-1].inertia):.9g}")
    if not (torch.equal(fits[0].centroids, fits[1].centroids)
            and torch.equal(fits[0].assign, fits[1].assign)):
        raise AssertionError("kmeans: two plain Lloyd fits from one start differ")
    log("kmeans two plain fits from one start: centroids and assignments equal bit for bit")
    km_mod.launches = 0
    t0 = time.perf_counter()
    fit = km.lloyd(x, init, iters, use_kernel=True)
    torch.cuda.synchronize()
    launches = km_mod.launches
    rel = abs(float(fit.inertia) - float(fits[0].inertia)) / float(fits[0].inertia)
    log(f"kmeans kernel Lloyd, {iters} iterations: {time.perf_counter() - t0:.2f} s, inertia "
        f"{float(fit.inertia):.9g} ({rel:.3g} from the plain fit's), kmeans_assign launches "
        f"{launches}")
    if launches != iters + 1:
        raise AssertionError(f"kmeans: kmeans_assign launched {launches} times, not {iters + 1}")
    if rel > 1e-3:
        raise AssertionError(f"kmeans: inertias differ by {rel:.3g} relative")
    cents = fit.centroids
    timed = {}
    for what, pts in (("base", x), ("made on the card", None)):
        if pts is None:  # base points drawn again, plus noise: the base's distribution
            g = torch.Generator(device=dev).manual_seed(1)
            pts = x[torch.randint(x.shape[0], (n_big,), generator=g, device=dev)]
            pts += torch.randn(pts.shape, generator=g, device=dev) * 0.1 * x.std(0)
        err, ties = compare_assign(f"kmeans_assign over {what}", pts, cents)
        ms = time_ms(lambda: km_mod.kmeans_assign(pts, cents), 5)
        plain_ms = time_ms(lambda: kops.kmeans_assign(pts, cents, impl="ref"), 2, 1)
        bound = bound_entry(*assign_bound(pts, cents))
        timed[what] = dict(n=pts.shape[0], err=err, near_ties=ties, ms=ms, plain_ms=plain_ms,
                           bound=bound)
        log(f"kmeans one pass over {pts.shape[0]} points ({what}) at the kernel fit's "
            f"centroids: kernel vs plain ok (max abs err {err:.3g}; {ties} near-ties "
            f"assigned differently); {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
            f"{bound[0]:.3f} ms by {bound[1]})")
        del pts
    base_t, big = timed["base"], timed["made on the card"]
    return kernel_entry(
        "kmeans_assign", "kmeans_assign.cu", "src/repro/kernels/kmeans_assign.py:51", launches,
        base_t["err"], base_t["ms"], base_t["plain_ms"], base_t["bound"],
        {"x": list(x.shape), "centroids": list(cents.shape), "near_ties": base_t["near_ties"],
         "at_n": {"n": big["n"], "ms": big["ms"], "plain_ms": big["plain_ms"],
                  "bound_ms": big["bound"][0], "near_ties": big["near_ties"]}})


def flat_phase(dev, queries, base, gtd, gti, k: int):
    """``ops.l2_topk`` of the queries against the whole base: launches
    counted, held against its plain version and against exact ground truth
    (up to ties at the k-th place), timed. Returns the kernel's JSON entry."""
    import numpy as np
    import torch

    from repro_torch import testing as rt
    from repro_torch.kernels import l2_topk as l2_mod
    from repro_torch.kernels import ops as kops

    q = torch.as_tensor(queries, device=dev)
    c = torch.as_tensor(base, device=dev)
    ids = torch.arange(c.shape[0], dtype=torch.int32, device=dev)
    l2_mod.flat_launches = 0
    d_k, i_k = kops.l2_topk(q, c, ids, k)
    torch.cuda.synchronize()
    launches = l2_mod.flat_launches
    require_launched("flat", {"l2_topk": launches}, ("l2_topk",))
    err = compare_scan("l2_topk main-path inputs", q, c, ids, k, batched=False)
    nq = q.shape[0]
    gerr = rt.assert_topk_match(d_k, i_k, gtd[:nq], gti[:nq], rt.l2_atol(q, c, ids),
                                what="l2_topk vs exact ground truth")
    same = int((i_k.cpu().numpy() == gti[:nq]).all(1).sum())
    splits = l2_mod.scan_splits(1, nq, c.shape[0], c.shape[1], k, dev)
    log(f"flat   l2_topk of {nq} queries over {c.shape[0]} points, k {k} ({splits} candidate "
        f"ranges): kernel vs plain ok (max abs err {err:.3g}); vs exact ground truth ok "
        f"(max abs err {gerr:.3g}, {same} of {nq} rows equal id for id)")
    ms = time_ms(lambda: l2_mod.l2_topk(q, c, ids, k), 5)
    plain_ms = time_ms(lambda: kops.l2_topk(q, c, ids, k, impl="ref"), 1, 1)
    return kernel_entry("l2_topk", "l2_topk.cu", "src/repro/kernels/l2_topk.py:69", launches,
                        err, ms, plain_ms, bound_entry(*scan_bound(q[None], c[None], ids[None], k)),
                        {"q": list(q.shape), "cands": list(c.shape), "k": k, "splits": splits,
                         "rows_equal_to_ground_truth": same})


def batched_phase(qp, qb, vec, ids, k: int):
    """``ops.l2_topk_batched`` of the f32 path's dispatch buffer expanded to
    [B, q_cap, d] (empty slots carry the sentinel row) against the store:
    launches counted, held against its plain version (occupied and empty
    slots apart, each under its own rows' tolerance) and, on the occupied
    slots, against ``l2_topk_qbuf`` on the same batch; timed. Returns the
    kernel's JSON entry."""
    import torch

    from repro_torch import testing as rt
    from repro_torch.kernels import l2_topk as l2_mod
    from repro_torch.kernels import ops as kops

    q3 = qp[qb.long()]
    l2_mod.batched_launches = 0
    d_k, i_k = kops.l2_topk_batched(q3, vec, ids, k)
    torch.cuda.synchronize()
    launches = l2_mod.batched_launches
    require_launched("batched", {"l2_topk_batched": launches}, ("l2_topk_batched",))
    d_p, i_p = kops.l2_topk_batched(q3, vec, ids, k, impl="ref")
    occ = rt.occupied(qp, qb)
    err = rt.assert_topk_match(d_k[occ], i_k[occ], d_p[occ], i_p[occ],
                               rt.l2_atol(q3[occ], vec, ids),
                               what="l2_topk_batched main-path inputs, occupied slots")
    if bool((~occ).any()):  # the sentinel rows, under their own (far larger) tolerance
        rt.assert_topk_match(d_k[~occ], i_k[~occ], d_p[~occ], i_p[~occ],
                             rt.l2_atol(q3[~occ], vec, ids),
                             what="l2_topk_batched main-path inputs, empty slots")
    del d_p, i_p
    d_q, i_q = kops.l2_topk_qbuf(qp, qb, vec, ids, k)
    qerr = rt.assert_topk_match(d_k[occ], i_k[occ], d_q[occ], i_q[occ],
                                rt.qbuf_atol(qp, qb, vec, ids),
                                what="l2_topk_batched vs l2_topk_qbuf")
    equal = torch.equal(d_k[occ], d_q[occ]) and torch.equal(i_k[occ], i_q[occ])
    log(f"batch  l2_topk_batched over {tuple(q3.shape)} x {tuple(vec.shape)}: kernel vs plain "
        f"ok (occupied slots max abs err {err:.3g}); vs l2_topk_qbuf on the "
        f"{int(occ.sum())} occupied slots ok (max abs err {qerr:.3g}, "
        f"{'equal bit for bit' if equal else 'not bit-equal'})")
    ms = time_ms(lambda: l2_mod.l2_topk_batched(q3, vec, ids, k), 10)
    plain_ms = time_ms(lambda: kops.l2_topk_batched(q3, vec, ids, k, impl="ref"), 1, 1)
    return kernel_entry("l2_topk_batched", "l2_topk.cu", "src/repro/kernels/l2_topk.py:146",
                        launches, err, ms, plain_ms, bound_entry(*scan_bound(q3, vec, ids, k)),
                        {"q": list(q3.shape), "cands": list(vec.shape), "k": k,
                         "valid_candidates": int((ids >= 0).sum()),
                         "equal_to_l2_topk_qbuf": equal})


# ---------------------------------------------------------------- serving

def serve(eng, queries, tier, counters, n_base, what):
    """``len(queries) / BATCH`` batches through ``search(tier=...)`` with
    every kernel's launch counter zeroed just before and read just after.
    Checks the answers' shape, range and uniqueness; returns the ids and the
    launches."""
    import numpy as np

    for mod in counters.values():
        mod.launches = 0
    ids_out, nprobe, overflow, batch_s = [], [], 0, []
    for s in range(0, len(queries), BATCH):
        t1 = time.perf_counter()
        res = eng.search(queries[s:s + BATCH], tier=tier)
        batch_s.append(time.perf_counter() - t1)
        ids_out.append(res.ids)
        nprobe.append(res.nprobe_eff)
        overflow += res.overflow
    launches = {name: mod.launches for name, mod in counters.items()}
    ids_out = np.concatenate(ids_out)
    log(f"{what}: served {len(queries)} queries in {len(batch_s)} batches of {BATCH} "
        f"(tier {res.stats.tier}, bucket {res.stats.bucket}, impl {res.stats.impl}): "
        f"{len(queries) / sum(batch_s):.1f} QPS over all batches, "
        f"{BATCH / float(np.median(batch_s)):.1f} QPS at the median batch "
        f"({1e3 * float(np.median(batch_s)):.1f} ms; first {1e3 * batch_s[0]:.1f} ms)")
    log(f"{what}: mean nprobe_eff {float(np.concatenate(nprobe).mean()):.3f} | overflow "
        f"{overflow} | launches over {len(batch_s)} batches {launches}")
    k = eng.cfg.k
    if ids_out.shape != (len(queries), k) or (ids_out >= n_base).any():
        raise AssertionError(f"{what}: bad result ids: shape {ids_out.shape}")
    if any(len(set(r[r >= 0].tolist())) != int((r >= 0).sum()) for r in ids_out):
        raise AssertionError(f"{what}: duplicate ids in a result row")
    return ids_out, launches


def residual_distortion(eng, step: int = 16) -> float:
    """Σ‖r − r̂‖² / Σ‖r‖² over the valid slots of a residual_pq store, r the
    residual x − centroid and r̂ its decoded code: the share of the
    residuals' energy the codes lose."""
    from repro_torch.core import pq as pqmod

    st = eng.store
    book = pqmod.PQCodebook(st["codebooks"], eng.cfg.pq_m, eng.cfg.pq_ks)
    err = tot = 0.0
    for b0 in range(0, eng.cfg.n_partitions, step):
        valid = st["ids"][b0:b0 + step] >= 0
        cents = st["centroids"][b0:b0 + step, None, :].expand(-1, valid.shape[1], -1)
        r = st["vectors"][b0:b0 + step][valid].float() - cents[valid]
        rec = pqmod.decode(book, st["codes"][b0:b0 + step][valid])
        err += float(((r - rec) ** 2).sum())
        tot += float((r * r).sum())
    return err / tot


def require_launched(what, launches, names):
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"{what}: {name} was not launched")


def cuda_vs_ref(eng, q0, tier, what) -> None:
    """One batch served with impl="cuda" and again with impl="ref" agrees."""
    import numpy as np

    from repro_torch import testing as rt

    r_cuda = eng.search(q0, impl="cuda", tier=tier)
    r_ref = eng.search(q0, impl="ref", tier=tier)
    atol = rt.l2_atol(q0, eng.store["vectors"], eng.store["ids"])
    err = rt.assert_topk_match(r_cuda.dists, r_cuda.ids, r_ref.dists, r_ref.ids, atol,
                               what=f"{what} batch cuda vs ref")
    if not (np.array_equal(r_cuda.nprobe_eff, r_ref.nprobe_eff)
            and r_cuda.overflow == r_ref.overflow
            and r_cuda.stats.dedup_hits == r_ref.stats.dedup_hits):
        raise AssertionError(f"{what} batch: nprobe_eff / overflow / dedup_hits differ")
    log(f"{what}: one batch impl=cuda vs impl=ref: agree (max abs err {err:.3g}, "
        f"atol {atol:.3g})")


# ---------------------------------------------------------------- phases

def main(n_base: int = N_BASE, n_queries: int = N_QUERIES) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from repro_torch import testing as rt
    from repro_torch.core import ground_truth as gt
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.data.synthetic import make_vector_dataset
    from repro_torch.kernels import _build, dedup_topk as dd_mod, l2_topk as l2_mod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pq_adc as adc_mod
    from repro_torch.serving.api import BuildConfig
    from repro_torch.serving.engine import LiraEngine
    from repro_torch.utils.device import resolve_device

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)
    dev = resolve_device("cuda")
    # the plain versions are the oracles: their matmuls must run in full f32,
    # not TF32 (resolve_device sets the same; stated here for the comparisons)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {torch.cuda.get_device_name(0)} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build  {time.perf_counter() - t0:.1f} s wall ("
        + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()) + ")")
    for name in secs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build  {name}: {line.strip()}")

    # 3. edge cases
    edge_cases(dev)
    torch.cuda.synchronize()

    # 4. main paths: one residual_pq engine serves f32 and residual_pq
    t0 = time.perf_counter()
    ds = make_vector_dataset(n=n_base, n_queries=n_queries, dim=128, seed=0)
    log(f"main   dataset {ds.base.shape} + {ds.queries.shape} in {time.perf_counter() - t0:.1f} s")
    counters = {"l2_topk_qbuf": l2_mod, "dedup_topk": dd_mod, "pq_adc_topk_qbuf": adc_mod}
    captured = {}

    def capture(name, fn):
        def wrapped(*args, **kw):
            captured.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return wrapped

    orig = {name: getattr(kops, name) for name in counters}
    for name, fn in orig.items():
        setattr(kops, name, capture(name, fn))
    t0 = time.perf_counter()
    eng = LiraEngine.build(ds.base, BuildConfig(tier="residual_pq", **MAIN_BUILD), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    store_bytes = sum(t.numel() * t.element_size() for t in eng.store.values())
    log(f"main   build {build_s:.1f} s | capacity {eng.cfg.capacity} | store "
        f"{store_bytes / 2**30:.3f} GiB on the card ("
        + ", ".join(f"{n} {t.numel() * t.element_size() / 2**30:.3f}"
                    for n, t in eng.store.items()) + ") | " + str(eng.cfg))
    log(f"main   residual PQ codes lose {residual_distortion(eng):.4f} of the residuals' "
        f"energy (sum of squared reconstruction errors over the valid slots)")
    t0 = time.perf_counter()
    gtd, gti = gt.exact_knn(ds.queries, ds.base, 100, device=dev)
    log(f"main   exact ground truth on the card in {time.perf_counter() - t0:.1f} s")

    # the residual_pq path runs at lira-ann-q's rerank 4 (rk = 400), then again
    # at rerank 16 (rk = 1,600) to show how much of its recall gap to the
    # f32 path is the shortlist's depth
    deep = dataclasses.replace(eng, cfg=dataclasses.replace(eng.cfg, rerank=16))
    recall, inputs = {}, {}
    for path, engine, tier, needs in (
            ("f32", eng, "f32", ("l2_topk_qbuf", "dedup_topk")),
            ("residual_pq", eng, "residual_pq", ("pq_adc_topk_qbuf", "dedup_topk")),
            ("residual_pq rerank 16", deep, "residual_pq", ("pq_adc_topk_qbuf", "dedup_topk"))):
        captured.clear()
        what = f"main   {path}"
        ids_out, launches = serve(engine, ds.queries, tier, counters, n_base, what)
        inputs[path] = (dict(captured), launches)
        require_launched(what, launches, needs)
        recall[path] = recall_at_k(ids_out, gti, 100)
        log(f"{what}: recall@100 {recall[path]:.4f} against exact ground truth")
    for name, fn in orig.items():
        setattr(kops, name, fn)
    for tier in ("f32", "residual_pq"):
        cuda_vs_ref(eng, ds.queries[:BATCH], tier, f"main   {tier}")
    for tier in ("f32", "residual_pq"):
        profile_batch(eng, ds.queries[BATCH:2 * BATCH], f"main {tier}", tier=tier)
    # f32 reaches ~0.96 on an H100 and residual_pq ~0.89 at rerank 4 (PQ's
    # distortion on this data pushes true neighbours out of a 400-slot
    # shortlist); a broken build, dispatch, ADC scan, rerank or merge lands
    # far below either. With a 1,600-slot shortlist the quantized path must
    # come within 0.03 of the exact one.
    gap = recall["f32"] - recall["residual_pq rerank 16"]
    if gap > 0.03:
        raise AssertionError(f"residual_pq at rerank 16 recall@100 is {gap:.4f} below f32's")
    if n_base == N_BASE:
        floors = {"f32": 0.9, "residual_pq": 0.85, "residual_pq rerank 16": 0.9}
        for path, floor in floors.items():
            if recall[path] < floor:
                raise AssertionError(f"{path} recall@100 {recall[path]:.4f} < {floor}")

    # 5. the pq tier (non-residual) on its own, smaller build
    t0 = time.perf_counter()
    pq_base = ds.base[:N_PQ_BASE]
    eng_pq = LiraEngine.build(pq_base, BuildConfig(tier="pq", **MAIN_BUILD), device="cuda")
    torch.cuda.synchronize()
    log(f"pq     build over {len(pq_base)} points {time.perf_counter() - t0:.1f} s | capacity "
        f"{eng_pq.cfg.capacity} | {eng_pq.cfg}")
    _, gti_pq = gt.exact_knn(ds.queries, pq_base, 100, device=dev)
    ids_pq, launches_pq = serve(eng_pq, ds.queries, "pq", counters, len(pq_base), "pq     pq")
    require_launched("pq     pq", launches_pq, ("pq_adc_topk_qbuf", "dedup_topk"))
    ids_pf, _ = serve(eng_pq, ds.queries, "f32", counters, len(pq_base), "pq     f32")
    r_pq, r_pf = recall_at_k(ids_pq, gti_pq, 100), recall_at_k(ids_pf, gti_pq, 100)
    log(f"pq     recall@100 pq {r_pq:.4f}, its own f32 tier {r_pf:.4f}")
    if r_pq < r_pf - 0.05:
        raise AssertionError(f"pq recall@100 {r_pq:.4f} more than 0.05 below its f32 tier's "
                             f"{r_pf:.4f}")
    cuda_vs_ref(eng_pq, ds.queries[:BATCH], "pq", "pq     pq")
    del eng_pq

    # 6. kernels at the main paths' inputs
    kernels = []
    f32_in, f32_launches = inputs["f32"]
    (qp, qb, vec, ids, k), _ = f32_in["l2_topk_qbuf"]
    err = compare_l2("l2_topk_qbuf main-path inputs", qp, qb, vec, ids, k)
    ms = time_ms(lambda: l2_mod.l2_topk_qbuf(qp, qb, vec, ids, k), 10)
    plain_ms = time_ms(lambda: kops.l2_topk_qbuf(qp, qb, vec, ids, k, impl="ref"), 3, 1)
    kernels.append(kernel_entry(
        "l2_topk_qbuf", "l2_topk_qbuf.cu", "src/repro/kernels/l2_topk.py:247",
        f32_launches["l2_topk_qbuf"], err, ms, plain_ms,
        bound_entry(*l2_bound(qp, qb, vec, ids, k)),
        {"q_pad": list(qp.shape), "qbuf": list(qb.shape), "cands": list(vec.shape), "k": k,
         "occupied_slots": int(rt.occupied(qp, qb).sum())}))
    # one block scans one bucket: the heaviest bucket's share of the work
    # bounds what the other 131 SMs can hide
    work = rt.occupied(qp, qb).sum(1).double() * (ids >= 0).sum(1).double()
    log(f"kernel l2_topk_qbuf per-bucket work (occupied slots x valid candidates): "
        f"max {int(work.max())}, mean {float(work.mean()):.0f}, heaviest bucket "
        f"{100 * float(work.max() / work.sum()):.2f}% of the total; max occupied slots "
        f"{int(rt.occupied(qp, qb).sum(1).max())}, max valid candidates "
        f"{int((ids >= 0).sum(1).max())}")
    (pd, pi, k), _ = f32_in["dedup_topk"]
    err = compare_dedup("dedup_topk main-path inputs", pd, pi, k)
    ms = time_ms(lambda: dd_mod.dedup_topk(pd, pi, k), 10)
    plain_ms = time_ms(lambda: kops.dedup_topk(pd, pi, k, impl="ref"), 3, 1)
    kernels.append(kernel_entry(
        "dedup_topk", "dedup_topk.cu", "src/repro/kernels/dedup_topk.py:137",
        f32_launches["dedup_topk"], err, ms, plain_ms,
        bound_entry(pd.numel() * 8 + pd.shape[0] * k * 8, 0.0, PEAK_OPS["float32"]),
        {"pool": list(pd.shape), "k": k, "valid": int(((pi >= 0) & torch.isfinite(pd)).sum())}))
    res_in, res_launches = inputs["residual_pq"]
    (lut, qb, codes, slots, rk), kw = res_in["pq_adc_topk_qbuf"]
    coff, qoff = kw["cand_off"], kw["q_off"]
    err = compare_adc("pq_adc_topk_qbuf main-path inputs", lut, qb, codes, slots, rk, coff, qoff)
    ms = time_ms(lambda: adc_mod.pq_adc_topk_qbuf(lut, qb, codes, slots, rk, cand_off=coff,
                                                   q_off=qoff), 10)
    plain_ms = time_ms(lambda: kops.pq_adc_topk_qbuf(lut, qb, codes, slots, rk, cand_off=coff,
                                                     q_off=qoff, impl="ref"), 3, 1)
    kernels.append(kernel_entry(
        "pq_adc_topk_qbuf", "pq_adc_topk_qbuf.cu", "src/repro/kernels/pq_adc.py:362",
        res_launches["pq_adc_topk_qbuf"], err, ms, plain_ms,
        bound_entry(*adc_bound(lut, qb, codes, slots, rk, coff, qoff)),
        {"lut_pad": list(lut.shape), "qbuf": list(qb.shape),
         "codes": [*codes.shape, str(codes.dtype)], "k": rk,
         "occupied_slots": int(rt.occupied(lut, qb).sum())}))
    # one block takes one group of G slots of one bucket
    g = adc_mod.slots_per_block(lut, codes, rk)
    occ = rt.occupied(lut, qb)
    occ = torch.nn.functional.pad(occ, (0, (-occ.shape[1]) % g)).reshape(occ.shape[0], -1, g)
    work = occ.sum(-1).double() * (slots >= 0).sum(1).double()[:, None]
    log(f"kernel pq_adc_topk_qbuf per-block work (occupied slots x valid candidates, "
        f"{g} slots a block, {work.numel()} blocks, {int((work > 0).sum())} with work): "
        f"max {int(work.max())}, mean over blocks with work "
        f"{float(work[work > 0].mean()):.0f}, heaviest block "
        f"{100 * float(work.max() / work.sum()):.2f}% of the total")

    # 7-9. the build's k-means through the kernel, the flat and the batched scan
    kernels.append(kmeans_phase(dev, ds.base, 10 * n_base))
    kernels.append(flat_phase(dev, ds.queries[:BATCH], ds.base, gtd, gti, 100))
    (qp, qb, vec, ids, k), _ = f32_in["l2_topk_qbuf"]
    kernels.append(batched_phase(qp, qb, vec, ids, k))

    for kern in kernels:
        log(f"kernel {kern['name']}: {kern['ms']:.3f} ms (plain {kern['plain_ms']:.3f} ms, "
            f"bound {kern['bound_ms']:.3f} ms by {kern['bound_by']}), no single PyTorch call "
            f"computes the same function")
    log(f"total  {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
