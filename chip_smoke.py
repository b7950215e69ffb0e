#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LIRA on one NVIDIA card, end to end.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device  — the card's name and power limit, torch and CUDA versions;
  2. build   — nvcc compiles every kernel under src/repro_torch/csrc/, all at once;
  3. edges   — each kernel against its plain PyTorch version on the card, at
               repro_torch.testing's edge cases (padding ids, k > pool,
               duplicate ids, exact ties, non-finite distances, bf16 store,
               for the L2 scans distances falling along each set, one
               distance for every candidate, sets ten times k long, ||c||^2
               overflowing to +inf, a hot bucket over several slot groups,
               residual offsets, uint16 codes, empty slots, buckets and rows
               with nothing valid, ties across the flat scan's candidate
               ranges; for the ADC selection, distances falling along each
               row, k above the valid count, one distance for every
               candidate, rows many times k long, -inf, +inf and NaN
               offsets; ragged N and B, B = 1, d not a multiple of 4,
               duplicate centroids; the ADC cases also through the full, flat
               and batched ADC, expanded through the dispatch buffer, with
               query counts that are no multiple of the flat kernels' rows a
               block, 16 codewords, codes off a 16-byte boundary, lists too
               large for the widest row group, and LUT rows of 64 and 128 KB)
               at the main paths' widths, under the same rule the tests use;
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
               agree;
  5. pq      — a second engine with tier pq at 100,000 base points (same
               widths), built twice from one seed (every probing parameter
               and store plane equal bit for bit): launches, recall@100
               against its own f32 tier, and cuda vs ref;
  6. kernels — each kernel against its plain version on the inputs the main
               paths gave it, timed with CUDA events beside its bound;
               l2_topk_qbuf also with every dispatch slot empty and over
               the store padded to lira-ann-q's capacity of 65,536 (equal
               bit for bit), its launch shape (slots a group, shared memory,
               blocks an SM) and how its work spreads over its work items
               (the heaviest item's share); pq_adc_topk_qbuf also at the rerank-16 path's stage 1
               (rk = 1,600) and with every dispatch slot empty, and its
               launch shape at both rk;
  7. kmeans  — the build's k-means over the 1M base (B = 1024, 20 Lloyd
               iterations from one k-means++ start): two plain fits must be
               equal bit for bit, a fit through kmeans_assign (21 launches)
               must reach the plain inertia within 1e-3, and one assignment
               pass at its centroids is held kernel vs plain (near-ties
               counted) and timed over the base and over 10M points made on
               the card, beside its bound on the TF32 tensor cores (three
               products), its CUDA-core bound and torch.mm of the same
               product alone; its launch shape and registers are logged;
  8. flat    — l2_topk of the first 1,000 queries over the whole base at
               k = 100, held against its plain version and against exact
               ground truth (up to ties at the 100th place), timed; its
               candidate ranges and launch shape are logged;
  9. batched — l2_topk_batched of the f32 path's first dispatch buffer
               expanded to [1024, 128, 128] against the store, held against
               its plain version and, on the occupied slots, against
               l2_topk_qbuf; timed.
 10. adc-full — a plain (non-residual) PQ of the 1M base (m = 16, ks = 256,
               trained on 32,768 rows, every point encoded): pq_adc of the
               first 1,000 queries' LUTs over the 1M codes, the full [1,000,
               1M] ADC matrix, equal bit for bit to its plain version; timed;
               its launch plan, its gather floor (Q·N·m shared-memory reads
               at 32 words a clock an SM) and the mean wavefronts a gather
               under the old and the new lane map, on 65,536 of its codes;
 11. adc-flat — pq_adc_topk of the same LUTs over the same codes at k = 100,
               the exhaustive PQ search: equal to its plain version
               (distances bit for bit, ids too) and to a stable top-100 of
               phase 10's matrix; recall@100 against exact ground truth is
               reported, with no floor; timed; plan, floor and wavefronts
               as phase 10;
 12. adc-batched — pq_adc_topk_batched of the residual_pq path's first
               dispatch buffer expanded to [1024, 128, 16, 256] LUTs against
               its codes, slots and offsets at rk = 400: equal to its plain
               version on every slot and, on the occupied slots, to
               pq_adc_topk_qbuf bit for bit; timed.
 13. surface — the serve surface of the main engine: one batch of each path
               (f32, residual_pq at rerank 4 and 16) with a Tracer on, under
               obs.profile_capture, equal bit for bit to the same batch with
               both off, and its device time per profiler range
               (lira.probing / dispatch / scan / merge) and within each range
               by operation, beside the batch's wall time and the device's
               busy time (a capture counts only when every device event is
               matched to its launch and none is lost); a new σ misses the serve cache and a second
               search of its bucket hits; on the f32 and the residual_pq
               path a front-end (time.monotonic, max_batch 1,000;
               q_cap_factor B / nprobe_max, so no probe can be dropped)
               takes 1,000 single-query requests: p50 / p99 latency, QPS,
               mean batch rows, each answer held against one solo search()
               of the same queries under the comparison rule (rows equal bit
               for bit counted, and those equal to a direct search of the
               batch they rode in); the pq engine of phase 5
               saved and loaded, one batch equal bit for bit;
 14. churn   — on the main engine, in shares of its 1M base rows: 50,000
               deletes, a batch at f32 and residual_pq (no deleted id, the
               three serve kernels launched), compact(), the same batches
               equal bit for bit; five rounds of 30,000 deletes, 20,000
               inserts (base rows plus noise at 1% of the base's standard
               deviation) and maybe_repartition(), an f32 batch each with
               l2_topk_qbuf and dedup_topk launched; noisy copies of the
               hottest partition's centroid beyond its window's free slots
               (capacity grows ≥ 1.5x, the epoch bumps, the next search
               misses the cache, cuda vs ref agrees on both paths); a forced
               repartition, then recall@100 of both paths against exact
               ground truth over the live rows (f32 ≥ 0.9) beside a fresh
               build of the live rows; wall seconds of each operation, peak
               device memory, the card's name and power limit.
 15. mesh    — run after 13, before 14: the main engine's 10 batches of
               1,000 served over a mesh of data 1 x model 4, every rank on
               the card (four blocks of 256 partitions), against the
               unsharded search: f32 equal bit for bit, residual_pq at
               rerank 4 under the comparison rule with the rows equal bit
               for bit counted, nprobe_eff and overflow equal, dedup_hits at
               most the unsharded count; each batch launches the scan once a
               rank and dedup_topk once a rank plus once to merge across
               ranks; the three serve kernels held against their plain
               versions at the meshed shapes (a block of 256 partitions, a
               cross-rank pool of 4 x 100) and timed beside their bounds;
               impl="cuda" against "ref" on the meshed step; then data 2 x
               model 2 (each half of a batch equal bit for bit to an
               unsharded search of that half alone); with two cards or more
               also one rank a card; the median batch meshed and unsharded.
 16. cluster — after churn, the main engine freed: a LiraCluster of 4 hash
               shards x 2 replicas over the 1M base, each shard a lira-ann-q
               engine over its ~250,000 rows trained on as many rows as the
               single engine; per path recall@100 against phase 4's ground
               truth (f32 >= 0.9) and each batch equal bit for bit to
               dedup_topk_np of the shard engines' own searches; a replica
               killed with a batch in flight and one stalled (failed by tick
               on a FakeClock) leave every answer's bits; a whole dead group
               raises; a full fan-out exactness gate (4 shards over 100,000
               points, B = 64, sigma -1, no probe dropped) against one
               engine over the union and exact ground truth under the
               comparison rule; a front-end of 1,000 single-query requests
               against one solo cluster search; build seconds a shard,
               median batch, peak device memory; and the f32 recall of the
               same shards at the single engine's train_frac.
 17. eval    — run after 15, before 14, over the main engine's fresh store
               (a PartitionStore view: centroids, vectors, ids, counts of its
               occupancy) and its first 1,000 queries: the evaluation
               engine's partition_topk at q_batch 128 through l2_topk_qbuf
               over a dense dispatch buffer (8 launches; one block of all
               1,000 gives the same answer), the kernel held against its
               plain version on two blocks of 8 queries and timed beside its
               bound; a full probe merged equal to exact ground truth;
               evaluate_probe of probe_lira(p̂, σ) from the engine's own
               model at least the serve path's f32 recall query by query
               (queries below it only where the serve step probed a
               partition whose p̂ lies within 1e-4 of σ or of the top p̂,
               or tied at the k-th place, each counted); ids equal up to
               ties where both paths probe the same partitions; IVF swept to
               LIRA's recall, LIRA's cmp saving reported;
 18. train   — run after 17: the probing model through the port's Trainer
               over 100,000 base rows (nearest engine centroid, exact k = 100
               labels within the subset), ProbingPipeline at global batch
               512, AdamW on a cosine schedule, 400 steps, checkpoints every
               100; a run failed after step 250's update and resumed from
               step 200 ends equal bit for bit to an uninterrupted run;
               steps/s;
 19. examples — python -m repro_torch.examples.serve_ann (recall@10 of
               both tiers ≥ 0.65 and within 0.02), .quickstart (LIRA's cmp at
               most IVF's at matched recall) and .train_probing_model twice
               (the second run resumes at step 600), each a subprocess on
               the card at the example's own sizes.
 20. lm      — last, on a freed card: the LM substrate's serving path
               through build_bundle(get_config(...), make_test_mesh(1, 1)):
               (a) stablelm-3b whole (32 layers, d 2560, 32 heads x 80, d_ff
               6912, vocab 50304, bf16) from a seeded generator: prefill of
               [8, 2048] random tokens, its cache copied into a 4,096-position
               one, 64 greedy decode steps from position 2048, each run
               once untimed and once timed; prefill ms and tokens/s beside
               its bound by operations (every KV block counted) at the bf16
               peak, decode ms a step and tokens/s beside its bound by bytes
               (weights and the whole cache), peak device memory; one
               layer's attention timed through the block scan and through
               scaled_dot_product_attention (a reference only); (b) the
               same width at 2 layers in f32 on the card and the CPU (the
               same parameters): prefill [2, 256] logits within 1e-3, 8
               decode steps equal token for token; (c) on the card each of
               those decode tokens equal to the argmax of a prefill over the
               prompt and the tokens before it where the top-2 margin is
               wider than 2e-3 (the rest counted); (d) moonshot-v1-16b-a3b's
               width (64 experts top-6 + 2 shared) at 4 layers: prefill
               [4, 2048], 32 decode steps, timed as (a), with the MoE
               capacity and dropped (token, expert) pairs, and (b)'s gate at
               2 layers in f32 (prefill [2, 64], 4 steps).
Phase 20 launches none of the kernels: the LM's attention is the reference's
plain block scan, and no Pallas kernel lies on its path.
Phases 7-12, 15-16 and 17 zero the launch counters just before each path and
read them just after. Every matmul runs in full f32 (TF32 off for matmul and cuDNN),
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
# phase 18 runs cuBLAS under deterministic algorithms, which needs its
# workspace fixed before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(ROOT, "src"))

N_BASE, N_PQ_BASE, N_QUERIES, BATCH = 1_000_000, 100_000, 10_000, 1_000
# lira-ann-q (configs/lira_ann.py:CONFIG_QUANTIZED) as a build recipe
MAIN_BUILD = dict(n_partitions=1024, k=100, nprobe_max=64, eta=0.03, sigma=0.5,
                  train_frac=0.1, pq_m=16, pq_ks=256, rerank=4)
HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
SM_CLOCK_HZ = 1.98e9                    # the clock behind the 67 TFLOP/s f32 peak
SMEM_WORDS_PER_CLOCK = 32               # shared memory: 32 banks of 4 bytes an SM
PEAK_OPS = {"float32": 67e12,           # f32 on the CUDA cores
            "tf32": 495e12,             # dense TF32 tensor-core rate
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


def compare_adc_trio(what, lut_pad, qbuf, codes, cand_ids, k, cand_off, q_off) -> None:
    """The full, flat and batched ADC kernels vs their plain versions on the
    case expanded through qbuf (flat: buckets 0, with nothing valid, and 1),
    all equal; the batched kernel also equals the qbuf kernel on the
    occupied slots."""
    import torch

    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops

    lut = lut_pad[qbuf.long()]
    kw = dict(cand_off=cand_off, q_off=q_off)
    for b in (0, 1):
        if not torch.equal(kops.pq_adc(lut[b], codes[b], impl="cuda"),
                           kops.pq_adc(lut[b], codes[b], impl="ref")):
            raise AssertionError(f"{what}: pq_adc differs from its plain version")
        kb = {n: None if t is None else t[b] for n, t in kw.items()}
        args = (lut[b], codes[b], cand_ids[b], k)
        rt.assert_topk_match(*kops.pq_adc_topk(*args, impl="cuda", **kb),
                             *kops.pq_adc_topk(*args, impl="ref", **kb), 0.0, exact_ids=True,
                             what=f"{what}: pq_adc_topk, bucket {b}")
    d_k, i_k = kops.pq_adc_topk_batched(lut, codes, cand_ids, k, impl="cuda", **kw)
    rt.assert_topk_match(d_k, i_k, *kops.pq_adc_topk_batched(lut, codes, cand_ids, k, impl="ref",
                                                             **kw),
                         0.0, exact_ids=True, what=f"{what}: pq_adc_topk_batched")
    d_q, i_q = kops.pq_adc_topk_qbuf(lut_pad, qbuf, codes, cand_ids, k, impl="cuda", **kw)
    occ = rt.occupied(lut_pad, qbuf)
    rt.assert_topk_match(d_k[occ], i_k[occ], d_q[occ], i_q[occ], 0.0, exact_ids=True,
                         what=f"{what}: pq_adc_topk_batched vs pq_adc_topk_qbuf")


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
        if case in rt.ADC_UNALIGNED:
            codes = rt.unaligned(codes)
        coff, qoff = (None if a is None else torch.from_numpy(a).to(dev) for a in (coff, qoff))
        compare_adc(case, lut_pad, qbuf, codes, ids, k, coff, qoff)
        log(f"edges  pq_adc_topk_qbuf  {case}: ok, equal ({codes.dtype}, "
            f"S {qbuf.shape[1]}, N {codes.shape[1]}, k {k})")
        compare_adc_trio(case, lut_pad, qbuf, codes, ids, k, coff, qoff)
        log(f"edges  pq_adc / pq_adc_topk / pq_adc_topk_batched  {case}: ok, equal")
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


def qbuf_item_work(items, cand_ids):
    """Occupied slots x valid candidates of each work item of l2_topk_qbuf's
    plan (columns bucket, first slot, rows, c_lo, c_hi, ...), as float64."""
    import torch

    cum = torch.nn.functional.pad((cand_ids >= 0).cumsum(1), (1, 0)).cpu().double()
    b, rows, lo, hi = items[:, 0], items[:, 2], items[:, 3], items[:, 4]
    return rows.double() * (cum[b, hi] - cum[b, lo])


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
    """Least time for one assignment pass in the unit the kernel uses: x and
    the centroids read once, the assignment and its distance written once;
    for f32 three TF32 products (the hi/lo split), 3 · 2·d flops per (point,
    centroid) at the TF32 rate, for bf16 one product, 2·d flops at the bf16
    rate. Also returns the CUDA-core bound (2·d flops at the f32 rate)."""
    nbytes = (x.numel() + c.numel()) * x.element_size() + x.shape[0] * 8
    flops = 2.0 * x.shape[0] * c.shape[0] * x.shape[1]
    if x.element_size() == 2:  # bf16
        tensor = (nbytes, flops, PEAK_OPS["bfloat16"])
    else:
        tensor = (nbytes, 3 * flops, PEAK_OPS["tf32"])
    return tensor, (nbytes, flops, PEAK_OPS["float32"])


def ptxas_report(name: str, entry: str) -> dict:
    """Registers and spill bytes nvcc's -Xptxas -v reported for the kernel of
    library ``name`` whose mangled name contains ``entry``."""
    from repro_torch.kernels import _build

    out, inside = {}, False
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            inside = entry in line
        elif inside and "spill stores" in line:
            parts = line.split(",")
            out["spill_store_bytes"] = int(parts[1].split()[0])
            out["spill_load_bytes"] = int(parts[2].split()[0])
        elif inside and "Used" in line and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split()[0])
    return out


def bound_entry(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    shape = km_mod.launch_shape(x, cents)
    shape.update(ptxas_report("kmeans_assign", "kmeans_assign_kernelIf"))
    log(f"kmeans kmeans_assign launch (f32): {shape}")
    timed = {}
    for what, pts in (("base", x), ("made on the card", None)):
        if pts is None:  # base points drawn again, plus noise: the base's distribution
            g = torch.Generator(device=dev).manual_seed(1)
            pts = x[torch.randint(x.shape[0], (n_big,), generator=g, device=dev)]
            pts += torch.randn(pts.shape, generator=g, device=dev) * 0.1 * x.std(0)
        err, ties = compare_assign(f"kmeans_assign over {what}", pts, cents)
        ms = time_ms(lambda: km_mod.kmeans_assign(pts, cents), 5)
        plain_ms = time_ms(lambda: kops.kmeans_assign(pts, cents, impl="ref"), 2, 1)
        mm_ms = None
        if what == "base":
            # the product alone, in full f32 (TF32 off, as set in main): a yardstick
            # for the part of the work a library does, not the argmin. Its [N, B]
            # output is 4 GB here (41 GB at 10M points, so not timed there)
            mm_ms = time_ms(lambda: torch.mm(pts, cents.T), 5)
            torch.cuda.empty_cache()
        tensor, cuda_core = assign_bound(pts, cents)
        bound, core_bound = bound_entry(*tensor), bound_entry(*cuda_core)
        timed[what] = dict(n=pts.shape[0], err=err, near_ties=ties, ms=ms, plain_ms=plain_ms,
                           bound=bound, core_bound=core_bound, mm_ms=mm_ms)
        log(f"kmeans one pass over {pts.shape[0]} points ({what}) at the kernel fit's "
            f"centroids: kernel vs plain ok (max abs err {err:.3g}; {ties} near-ties "
            f"assigned differently); {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
            f"{bound[0]:.3f} ms by {bound[1]} on the TF32 tensor cores, CUDA-core bound "
            f"{core_bound[0]:.3f} ms" + ("" if mm_ms is None else
                                            f"; torch.mm product only {mm_ms:.3f} ms") + ")")
        del pts
    base_t, big = timed["base"], timed["made on the card"]
    return kernel_entry(
        "kmeans_assign", "kmeans_assign.cu", "src/repro/kernels/kmeans_assign.py:51", launches,
        base_t["err"], base_t["ms"], base_t["plain_ms"], base_t["bound"],
        {"x": list(x.shape), "centroids": list(cents.shape), "near_ties": base_t["near_ties"],
         "bound_unit": "3 TF32 products at 495 TFLOP/s", "launch": shape,
         "cuda_core_bound_ms": base_t["core_bound"][0], "product_only_mm_ms": base_t["mm_ms"],
         "at_n": {"n": big["n"], "ms": big["ms"], "plain_ms": big["plain_ms"],
                  "bound_ms": big["bound"][0], "cuda_core_bound_ms": big["core_bound"][0],
                  "near_ties": big["near_ties"]}})


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
    shape = l2_mod.scan_occupancy(c, k)
    log(f"flat   l2_topk of {nq} queries over {c.shape[0]} points, k {k} ({splits} candidate "
        f"ranges; launch shape {shape}): kernel vs plain ok (max abs err {err:.3g}); vs exact "
        f"ground truth ok (max abs err {gerr:.3g}, {same} of {nq} rows equal id for id)")
    ms = time_ms(lambda: l2_mod.l2_topk(q, c, ids, k), 5)
    plain_ms = time_ms(lambda: kops.l2_topk(q, c, ids, k, impl="ref"), 1, 1)
    return kernel_entry("l2_topk", "l2_topk.cu", "src/repro/kernels/l2_topk.py:69", launches,
                        err, ms, plain_ms, bound_entry(*scan_bound(q[None], c[None], ids[None], k)),
                        {"q": list(q.shape), "cands": list(c.shape), "k": k, "splits": splits,
                         "launch": shape, "rows_equal_to_ground_truth": same})


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


# ---------------------------------------------------------------- the ADC trio

PQ_TRAIN_ROWS = 32_768


def adc_topk_bound(lut, codes, cand_ids, k, cand_off, q_off):
    """Least time for a batched ADC top-k (the flat one is one bucket): each
    input read once (every LUT row, every id and offset, the valid
    candidates' codes), each output written once; m − 1 additions plus one
    per offset for each (query row, valid candidate of its bucket), at the
    f32 rate."""
    m = codes.shape[-1]
    valid = (cand_ids >= 0).sum(-1).double()
    rows = lut.shape[-3]
    nbytes = (lut.numel() * 4 + float(valid.sum()) * m * codes.element_size()
              + cand_ids.numel() * 4
              + sum(t.numel() * 4 for t in (cand_off, q_off) if t is not None)
              + lut.shape[:-2].numel() * k * 8)
    adds = m - 1 + (cand_off is not None) + (q_off is not None)
    return nbytes, float(valid.sum()) * rows * adds, PEAK_OPS["float32"]


def gather_floor_ms(q: int, n: int, m: int) -> float:
    """The least time of the flat ADC kernels' LUT gathers: Q·N·m 4-byte
    reads from shared memory at 32 words a clock on each SM."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return q * n * m / (sms * SMEM_WORDS_PER_CLOCK * SM_CLOCK_HZ) * 1e3


def gather_wavefronts(codes, ks: int, rows: int, v: int, t: int) -> float:
    """A model, not a reading from the card (it has no bank-conflict
    counter here): the mean shared-memory wavefronts a 32 words gathered, for
    ``codes`` [n, m] (a sample of the phase's own) under adc_tile.cuh's lane
    map: ``rows``
    query rows a block in slabs of ``v`` interleaved (a lane reads v words
    at once), ``t`` consecutive candidates a lane. rows = v = t = 1 is the
    map of the kernels before: one candidate a lane. A request of v words a
    lane goes in v phases of 32 / v lanes; a phase takes as many wavefronts
    as the most distinct words any bank holds."""
    import numpy as np

    c = np.asarray(codes, dtype=np.int64)
    n_m = c.shape[1]
    slabs = rows // v
    span = (32 // slabs) * t
    c = c[:len(c) // span * span].reshape(-1, 32 // slabs, t, n_m)   # [tile, group, t, m]
    steps = c.transpose(0, 2, 1, 3).reshape(-1, 32 // slabs, n_m)     # [step, group, m]
    stride = v * n_m * ks + ((32 // slabs - v * n_m * ks) & 31)
    lane = np.arange(32)
    slab, group = lane % slabs, lane // slabs
    word = (slab * stride)[None, :, None, None] + (
        (steps[:, group, :] + np.arange(n_m) * ks) * v)[..., None] + np.arange(v)  # [step, lane, m, v]
    per_phase = 32 // v
    word = word.transpose(0, 2, 1, 3).reshape(-1, v, per_phase * v)   # [request, phase, words]
    word = np.sort(word, axis=-1)
    new = np.ones(word.shape, bool)
    new[..., 1:] = word[..., 1:] != word[..., :-1]
    slot = (np.arange(word.shape[0] * v).reshape(-1, v)[..., None] * 32 + word % 32)
    counts = np.bincount(slot[new], minlength=word.shape[0] * v * 32).reshape(-1, v, 32)
    return float(counts.max(-1).sum(-1).mean() / v)


def adc_gather_log(what, codes, lut, plan: dict, v: int, t: int, bound) -> None:
    """Log a flat ADC kernel's launch plan, its gather floor (worked out at
    an assumed clock) beside its bound, and the modelled wavefronts a gather
    under the old and the new lane map on a sample of the phase's codes."""
    q, m, ks = lut.shape
    sample = codes[:65536].cpu().numpy()
    old = gather_wavefronts(sample, ks, 1, 1, 1)
    new = gather_wavefronts(sample, ks, plan["rows_per_block"], v, t)
    floor = gather_floor_ms(q, codes.shape[0], m)
    log(f"adc    {what} launch plan {plan}; gather floor {floor:.3f} ms ({q} x {codes.shape[0]} "
        f"x {m} reads at {SMEM_WORDS_PER_CLOCK} words a clock an SM, {SM_CLOCK_HZ / 1e9} GHz) "
        f"beside the bound {bound[0]:.3f} ms by {bound[1]}; modelled (gather_wavefronts, not "
        f"measured) wavefronts a 32-word gather on {len(sample)} of these codes: one candidate "
        f"a lane {old:.3f}, this map (R {plan['rows_per_block']}, gathers of {v} rows, {t} "
        f"candidates a lane) {new:.3f}")


def adc_full_phase(dev, queries, base):
    """Train a plain PQ of the base, encode it, and take ``ops.pq_adc`` of
    the queries' LUTs over every code: launches counted, equal bit for bit to
    its plain version, timed. Returns the kernel's JSON entry and (the LUTs,
    the codes, the matrix) for the next phase."""
    import torch

    from repro_torch.core import pq as pqmod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pq_adc as adc_mod

    x = torch.as_tensor(base, device=dev)
    t0 = time.perf_counter()
    book = pqmod.train_pq(x[:PQ_TRAIN_ROWS], m=MAIN_BUILD["pq_m"], ks=MAIN_BUILD["pq_ks"],
                          generator=torch.Generator(device=dev).manual_seed(0))
    codes = pqmod.encode(book, x)
    lut = pqmod.adc_lut(book, torch.as_tensor(queries, device=dev))
    torch.cuda.synchronize()
    del x
    log(f"adc    PQ m {book.m}, ks {book.ks} trained on {PQ_TRAIN_ROWS} rows, "
        f"{codes.shape[0]} points encoded ({codes.dtype}) in {time.perf_counter() - t0:.1f} s")
    adc_mod.full_launches = 0
    d_k = kops.pq_adc(lut, codes)
    torch.cuda.synchronize()
    launches = adc_mod.full_launches
    require_launched("adc-full", {"pq_adc": launches}, ("pq_adc",))
    d_p = kops.pq_adc(lut, codes, impl="ref")
    err = float((d_k - d_p).abs().max())
    if not torch.equal(d_k, d_p):
        raise AssertionError(f"pq_adc: kernel and plain differ by up to {err}")
    del d_p
    log(f"adc    pq_adc of {tuple(lut.shape)} LUTs over {tuple(codes.shape)} codes -> "
        f"{tuple(d_k.shape)}: equal bit for bit to its plain version")
    ms = time_ms(lambda: adc_mod.pq_adc(lut, codes), 5)
    plain_ms = time_ms(lambda: kops.pq_adc(lut, codes, impl="ref"), 1, 1)
    nbytes = lut.numel() * 4 + codes.numel() * codes.element_size() + d_k.numel() * 4
    bound = bound_entry(nbytes, float(d_k.numel()) * (codes.shape[1] - 1), PEAK_OPS["float32"])
    plan = adc_mod.full_plan(lut.shape[0], codes.shape[0], lut.shape[1], lut.shape[2],
                             codes.element_size(), dev)
    adc_gather_log("pq_adc", codes, lut, plan, min(plan["rows_per_block"], 4), 8, bound)
    entry = kernel_entry("pq_adc", "pq_adc.cu", "src/repro/kernels/pq_adc.py:62", launches, err,
                         ms, plain_ms, bound,
                         {"lut": list(lut.shape), "codes": [*codes.shape, str(codes.dtype)],
                          "out": list(d_k.shape)})
    return entry, (lut, codes, d_k)


def adc_flat_phase(dev, lut, codes, full, gti, k: int):
    """``ops.pq_adc_topk`` of the LUTs over every code (the exhaustive PQ
    search): launches counted, equal to its plain version and to a stable
    top-k of phase 10's matrix, recall@k against exact ground truth
    reported; timed. Returns the kernel's JSON entry."""
    import torch

    from repro_torch import testing as rt
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pq_adc as adc_mod
    from repro_torch.kernels import ref as kref

    ids = torch.arange(codes.shape[0], dtype=torch.int32, device=dev)
    adc_mod.flat_launches = 0
    d_k, i_k = kops.pq_adc_topk(lut, codes, ids, k)
    torch.cuda.synchronize()
    launches = adc_mod.flat_launches
    require_launched("adc-flat", {"pq_adc_topk": launches}, ("pq_adc_topk",))
    d_p, i_p = kops.pq_adc_topk(lut, codes, ids, k, impl="ref")
    err = rt.assert_topk_match(d_k, i_k, d_p, i_p, 0.0, exact_ids=True,
                               what="pq_adc_topk main-path inputs")
    del d_p, i_p
    rows = 100  # the stable top-k of the [Q, N] matrix, a hundred rows at a time
    sd = torch.cat([kref.smallest_k(full[r:r + rows], k)[0] for r in range(0, len(full), rows)])
    if not torch.equal(d_k, sd):
        raise AssertionError("pq_adc_topk: distances differ from a stable top-k of pq_adc")
    nq = lut.shape[0]
    recall = recall_at_k(i_k.cpu().numpy(), gti[:nq], k)
    plan = adc_mod.flat_plan(nq, codes.shape[0], codes.shape[1], lut.shape[2], k,
                             codes.element_size(), dev)
    splits = plan["splits"]
    log(f"adc    pq_adc_topk of {nq} queries over {codes.shape[0]} codes, k {k} ({splits} "
        f"candidate ranges): equal to its plain version (distances and ids) and, in "
        f"distances, to a stable top-{k} of pq_adc; recall@{k} against exact ground truth "
        f"{recall:.4f} (exhaustive PQ, no floor)")
    ms = time_ms(lambda: adc_mod.pq_adc_topk(lut, codes, ids, k), 5)
    plain_ms = time_ms(lambda: kops.pq_adc_topk(lut, codes, ids, k, impl="ref"), 1, 1)
    bound = bound_entry(*adc_topk_bound(lut[None], codes[None], ids[None], k, None, None))
    adc_gather_log("pq_adc_topk", codes, lut, plan, min(plan["rows_per_block"], 4), 4, bound)
    return kernel_entry("pq_adc_topk", "pq_adc_topk.cu", "src/repro/kernels/pq_adc.py:131",
                        launches, err, ms, plain_ms, bound,
                        {"lut": list(lut.shape), "codes": [*codes.shape, str(codes.dtype)],
                         "k": k, "splits": splits, "recall_at_k": recall})


def adc_batched_phase(lut_pad, qb, codes, slots, rk: int, coff, qoff):
    """``ops.pq_adc_topk_batched`` of the residual_pq path's dispatch buffer
    expanded to [B, q_cap, m, ks] LUTs (empty slots carry the zero row)
    against its codes, slots and offsets: launches counted, equal to its
    plain version on every slot and to ``pq_adc_topk_qbuf`` on the occupied
    slots; timed. Returns the kernel's JSON entry."""
    import torch

    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pq_adc as adc_mod

    lut = lut_pad[qb.long()]
    kw = dict(cand_off=coff, q_off=qoff)
    adc_mod.batched_launches = 0
    d_k, i_k = kops.pq_adc_topk_batched(lut, codes, slots, rk, **kw)
    torch.cuda.synchronize()
    launches = adc_mod.batched_launches
    require_launched("adc-batched", {"pq_adc_topk_batched": launches}, ("pq_adc_topk_batched",))
    d_p, i_p = kops.pq_adc_topk_batched(lut, codes, slots, rk, impl="ref", **kw)
    err = rt.assert_topk_match(d_k, i_k, d_p, i_p, 0.0, exact_ids=True,
                               what="pq_adc_topk_batched main-path inputs, every slot")
    del d_p, i_p
    d_q, i_q = kops.pq_adc_topk_qbuf(lut_pad, qb, codes, slots, rk, **kw)
    occ = rt.occupied(lut_pad, qb)
    rt.assert_topk_match(d_k[occ], i_k[occ], d_q[occ], i_q[occ], 0.0, exact_ids=True,
                         what="pq_adc_topk_batched vs pq_adc_topk_qbuf, occupied slots")
    del d_q, i_q
    log(f"adc    pq_adc_topk_batched over {tuple(lut.shape)} LUTs x {tuple(codes.shape)} codes, "
        f"k {rk}: equal to its plain version on all {occ.numel()} slots and bit for bit to "
        f"pq_adc_topk_qbuf on the {int(occ.sum())} occupied slots")
    ms = time_ms(lambda: adc_mod.pq_adc_topk_batched(lut, codes, slots, rk, **kw), 10)
    plain_ms = time_ms(lambda: kops.pq_adc_topk_batched(lut, codes, slots, rk, impl="ref", **kw),
                       1, 1)
    return kernel_entry("pq_adc_topk_batched", "pq_adc_topk.cu",
                        "src/repro/kernels/pq_adc.py:233", launches, err, ms, plain_ms,
                        bound_entry(*adc_topk_bound(lut, codes, slots, rk, coff, qoff)),
                        {"lut": list(lut.shape), "codes": [*codes.shape, str(codes.dtype)],
                         "k": rk, "valid_candidates": int((slots >= 0).sum())})


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


# ---------------------------------------------------------------- serve surface and churn

def same_bits(a, b) -> bool:
    """Two SearchResults equal bit for bit: answers and counters."""
    import numpy as np

    return (np.array_equal(a.dists, b.dists) and np.array_equal(a.ids, b.ids)
            and np.array_equal(a.nprobe_eff, b.nprobe_eff) and a.overflow == b.overflow
            and a.stats.dedup_hits == b.stats.dedup_hits)


def range_profile(engine, queries, tier, what, captures: int = 3, attempts: int = 6) -> dict:
    """One batch with a Tracer attached, under ``profile_capture`` (the serve
    step's four ranges recorded), held bit for bit against the same batch
    with neither; logs the batch's wall time under the profiler, the
    device's busy time, and the device time of each range and, within it,
    of each operation. The profiler has been seen to drop a capture's device
    records, so a capture counts only when ``range_times`` matched every
    device event to the runtime call that launched it, found a device event
    for every launch, copy and fill call, and saw device time in every
    range. Up to ``attempts`` captures are taken until ``captures`` are
    complete, else the phase fails; the complete capture whose device time
    inside the ranges is the median is reported. Returns {"wall": ms,
    "busy": ms, range: ms, ...}."""
    import torch

    from repro_torch.obs import Tracer, profile_capture, range_times

    off = engine.search(queries, tier=tier)
    torch.cuda.synchronize()
    trace_dir = os.path.join(ROOT, "build", "profile", what.replace(" ", "_"))
    good, bad = [], []
    while len(good) < captures and len(good) + len(bad) < attempts:
        engine.tracer = Tracer()
        try:
            with profile_capture(trace_dir) as prof:
                t0 = time.perf_counter()
                on = engine.search(queries, tier=tier)
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            engine.tracer = None
        if not same_bits(off, on):
            raise AssertionError(f"{what}: the traced, profiled batch differs from the plain one")
        times = range_times(prof)
        empty = [n for n, rec in times["ranges"].items() if not rec["device_ms"] > 0]
        if times["unmatched"]["events"] or times["lost"] or empty:
            bad.append(f"{times['unmatched']['events']} device events unmatched "
                       f"({times['unmatched']['device_ms']:.3f} ms), {times['lost']} launches "
                       f"without a device event, no device time in {empty}")
            continue
        in_ranges = sum(rec["device_ms"] for rec in times["ranges"].values())
        good.append((in_ranges, wall, times, on))
    for reason in bad:
        log(f"ranges {what}: capture dropped: {reason}")
    if len(good) < captures:
        raise AssertionError(f"{what}: {len(good)} complete profiler captures of "
                             f"{len(good) + len(bad)}")
    in_ranges, wall, times, on = sorted(good, key=lambda run: run[0])[len(good) // 2]
    busy, out = times["busy_ms"], times["outside"]
    stages = ", ".join(f"{k} {v:.2f}" for k, v in on.stats.stages.items())
    log(f"ranges {what}: equal bit for bit with the ranges and a Tracer on and off; one "
        f"batch of {len(queries)}: wall {wall:.3f} ms under the profiler, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%), {in_ranges:.3f} of it inside the ranges, "
        f"{out['device_ms']:.3f} outside ("
        + ", ".join(f"{op[:32]} {ms:.3f}" for op, ms in list(out["ops"].items())[:3])
        + f"); {times['events']} device events, each matched to the call that launched it, "
        f"none lost; {len(good)} complete captures of {len(good) + len(bad)}, in the ranges "
        + ", ".join(f"{run[0]:.3f}" for run in good) + f" ms; spans (ms): {stages}; traces "
        f"under {os.path.relpath(trace_dir, ROOT)}")
    for name, rec in times["ranges"].items():
        ops = ", ".join(f"{op[:48]} {ms:.3f}" for op, ms in list(rec["ops"].items())[:6])
        log(f"ranges {what}:   {name:13s} {rec['device_ms']:8.3f} ms | {ops}")
    return {"wall": wall, "busy": busy,
            **{name: rec["device_ms"] for name, rec in times["ranges"].items()}}


def serve_surface_phase(eng, deep, eng_pq, ds) -> None:
    """13. The serve surface on the main engine: (a) per-range device time
    of each path, traced and profiled batches equal to plain ones; (b) the
    serve cache; (c) on the f32 and the residual_pq path, a front-end taking
    1,000 single-query requests, held against one solo search of the same
    queries and against a direct search of each batch; (d) save and load of
    the pq engine."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import testing as rt
    from repro_torch.configs.base import FrontendConfig
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving.api import SearchRequest
    from repro_torch.serving.engine import LiraEngine

    q = ds.queries[2 * BATCH:3 * BATCH]
    for what, engine, tier in (("f32", eng, "f32"), ("residual_pq", eng, "residual_pq"),
                               ("residual_pq rerank 16", deep, "residual_pq")):
        range_profile(engine, q, tier, f"surface {what}")

    # (b) the serve cache: a new σ misses, the same bucket again hits
    eng.metrics = MetricsRegistry()
    first = eng.search(q, sigma=0.45)
    again = eng.search(q[:900], sigma=0.45)
    if first.stats.cache_hit or not again.stats.cache_hit or again.stats.bucket != 1024:
        raise AssertionError(f"serve cache: first {first.stats.cache_hit}, second "
                             f"{again.stats.cache_hit} (bucket {again.stats.bucket})")
    m = eng.metrics
    log(f"surface serve cache: a new sigma missed, the same bucket hit; {len(eng._serve_cache)} "
        f"entries; registry: searches {m.counter('lira_engine_searches_total').total():.0f}, "
        f"hits {m.counter('lira_engine_jit_cache_hits_total').total():.0f}, misses "
        f"{m.counter('lira_engine_jit_cache_misses_total').total():.0f}, overflow rate "
        f"{eng.overflow_rate():.5f}")
    eng.metrics = None

    # (c) the front-end, on each path. q_cap = the bucket's rows (q_cap_factor
    # B / nprobe_max), so no probe can be dropped: coalescing must then not
    # change an answer. The f32 path's distances come from l2_topk_qbuf, one
    # fmaf chain a (row, candidate) whatever the batch; residual_pq's stage 2
    # (gathers, bmm) runs at shapes set by the bucket's q_cap
    fe_eng = dataclasses.replace(eng, cfg=dataclasses.replace(
        eng.cfg, q_cap_factor=eng.cfg.n_partitions / eng.cfg.nprobe_max))
    atol = rt.l2_atol(q, eng.store["vectors"], eng.store["ids"])
    for tier in ("f32", "residual_pq"):
        solo = fe_eng.search(q, tier=tier)
        fe = fe_eng.attach_frontend(FrontendConfig(max_batch=1000), clock=time.monotonic)
        pend = []
        t0 = time.perf_counter()
        for row in q:
            pend.append(fe.submit(SearchRequest(queries=row, tier=tier)))
            fe.poll()
        fe.drain()
        wall = time.perf_counter() - t0
        st = fe.stats()
        res = [p.result() for p in pend]
        if solo.overflow or any(r.stats.shed or r.overflow for r in res) or st.served != len(q):
            raise AssertionError(f"front-end {tier}: {st}, solo overflow {solo.overflow}")
        fe_eng.frontend = None
        n_bits = n_probe = n_ids = 0
        err = 0.0
        for i, r in enumerate(res):
            if not np.array_equal(r.nprobe_eff, solo.nprobe_eff[i:i + 1]):
                n_probe += 1    # the probing MLP's bits moved a σ near-tie
                continue
            err = max(err, rt.assert_topk_match(r.dists, r.ids, solo.dists[i:i + 1],
                                                solo.ids[i:i + 1], atol,
                                                what=f"front-end {tier} row {i} vs solo"))
            n_ids += bool(np.array_equal(r.ids, solo.ids[i:i + 1]))
            n_bits += bool(np.array_equal(r.dists, solo.dists[i:i + 1])
                           and np.array_equal(r.ids, solo.ids[i:i + 1]))
        if n_probe > len(q) // 100:
            raise AssertionError(f"front-end {tier}: {n_probe} rows probed other partitions "
                                 f"than solo")
        # the same rows against a direct search of the batch each rode in
        # (requests flush in order, so batch b holds the next batch_size rows)
        n_batch_bits = i = 0
        while i < len(res):
            rows = res[i].stats.batch_size
            direct = fe_eng.search(q[i:i + rows], tier=tier)
            n_batch_bits += sum(bool(np.array_equal(res[i + j].dists, direct.dists[j:j + 1])
                                     and np.array_equal(res[i + j].ids, direct.ids[j:j + 1]))
                                for j in range(rows))
            i += rows
        log(f"surface front-end {tier} (time.monotonic, max_batch {fe.max_batch}, max_wait "
            f"{fe.cfg.max_wait_ms} ms, q_cap_factor {fe_eng.cfg.q_cap_factor:g}): {st.served} "
            f"single-query requests in {st.batches} batches, mean {st.mean_batch:.1f} rows; "
            f"p50 {st.p50_ms:.3f} ms, p99 {st.p99_ms:.3f} ms, {st.qps:.1f} QPS "
            f"({len(q) / wall:.1f} over the submit loop's wall {wall:.3f} s); against one solo "
            f"search of the same {len(q)} queries: {n_bits} rows equal bit for bit, "
            f"{len(q) - n_bits - n_probe} within the rule ({n_ids} of all with ids equal in "
            f"order, max abs distance error {err:.3g}, atol {atol:.3g}), {n_probe} with "
            f"another nprobe_eff; {n_batch_bits} equal bit for bit to a direct search() of "
            f"the batch each rode in")

    # (d) save and load of the pq engine of phase 5
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    step_dir = eng_pq.save(ckpt)
    t_save = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in step_dir.iterdir())
    t0 = time.perf_counter()
    back = LiraEngine.load(ckpt, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    bad = [n for n in eng_pq.store if not torch.equal(eng_pq.store[n], back.store[n])]
    a, b = eng_pq.search(q, tier="pq"), back.search(q, tier="pq")
    if bad or not same_bits(a, b) or back.epoch != eng_pq.epoch:
        raise AssertionError(f"pq save/load: planes {bad} differ or the batch differs")
    log(f"surface pq save {t_save:.2f} s ({size / 2**30:.3f} GiB on disk), load {t_load:.2f} s; "
        f"every store plane and one batch of {len(q)} equal bit for bit")
    shutil.rmtree(ckpt, ignore_errors=True)


def churn_phase(eng, ds, counters, smi) -> None:
    """14. Churn on the main engine, in shares of its N = 1,000,000 base rows:
    (a) N/20 deletes, searches with holes, then compact, the same searches
    equal bit for bit; (b) five rounds of 3N/100 deletes, N/50 inserts and
    maybe_repartition, a batch each with the kernels' launches counted; (c)
    inserts that force growth; (d) a forced repartition and recall against
    exact ground truth over the live set and against a fresh build; (e) wall
    times and peak memory."""
    import numpy as np
    import torch

    from repro_torch.core import ground_truth as gt
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.serving import mutable
    from repro_torch.serving.api import BuildConfig
    from repro_torch.serving.engine import LiraEngine

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(14)
    n, d = ds.base.shape
    q = ds.queries[:BATCH]
    walls: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def counted(fn, names):
        for mod in counters.values():
            mod.launches = 0
        out = fn()
        launches = {name: counters[name].launches for name in names}
        require_launched("churn", launches, names)
        return out, launches

    order = rng.permutation(n)          # base ids in the order they are deleted
    n_dead, n_del, n_ins = n // 20, 3 * n // 100, n // 50
    # (a) tombstones, then compaction
    slots = timed("delete", lambda: eng.delete(order[:n_dead]))
    holey, launches = counted(lambda: {t: eng.search(q, tier=t) for t in ("f32", "residual_pq")},
                              ("l2_topk_qbuf", "pq_adc_topk_qbuf", "dedup_topk"))
    for tier, r in holey.items():
        if np.isin(r.ids, order[:n_dead]).any():
            raise AssertionError(f"churn: a deleted id surfaced ({tier})")
    cap0 = eng.cfg.capacity
    reclaimed = timed("compact", eng.compact)
    for tier, r in holey.items():
        if not same_bits(r, eng.search(q, tier=tier)):
            raise AssertionError(f"churn: the compacted store serves other bits ({tier})")
    log(f"churn  (a) deleted {n_dead} ids ({slots} slots with replicas); no deleted id in "
        f"{len(q)} queries at f32 and residual_pq (launches {launches}); compact: capacity "
        f"{cap0} -> {eng.cfg.capacity} ({reclaimed} slots), the same searches equal bit for "
        f"bit; delete {walls['delete'][0]:.3f} s, compact {walls['compact'][0]:.3f} s")

    # (b) churn rounds: new rows are base rows plus noise at 1% of the base's
    # per-dimension standard deviation, ids from N up
    std = ds.base.std(0)
    new_x, new_ids = [], []
    for rnd in range(5):
        dead = order[n_dead:n_dead + n_del]
        n_dead += n_del
        timed("delete", lambda: eng.delete(dead))
        x = (ds.base[rng.choice(n, n_ins, replace=False)]
             + rng.normal(0, 1, (n_ins, d)) * 0.01 * std).astype(np.float32)
        ids = np.arange(n_ins) + n + n_ins * rnd
        timed("insert", lambda: eng.insert(x, ids))
        new_x.append(x)
        new_ids.append(ids)
        fired = timed("maybe_repartition", eng.maybe_repartition)
        r, launches = counted(lambda: timed("search", lambda: eng.search(q, tier="f32")),
                              ("l2_topk_qbuf", "dedup_topk"))
        if np.isin(r.ids, order[:n_dead]).any():
            raise AssertionError(f"churn round {rnd}: a deleted id surfaced")
        log(f"churn  (b) round {rnd}: -{n_del} +{n_ins}, repartition {'ran' if fired else 'not due'}"
            f", staleness {eng.staleness():.4f}, capacity {eng.cfg.capacity}, epoch {eng.epoch}; "
            f"f32 batch launches {launches}, cache hit {r.stats.cache_hit}; delete "
            f"{walls['delete'][-1]:.3f} s, insert {walls['insert'][-1]:.3f} s, check "
            f"{walls['maybe_repartition'][-1]:.3f} s, search {walls['search'][-1]:.3f} s")
    churned = n // 20 + 5 * (n_del + n_ins)
    log(f"churn  (b) {churned} rows churned, {churned / n:.0%} of the base")

    # (c) noisy copies of the hottest partition's centroid, more than the free
    # slots of its PLACE_WINDOW nearest partitions: the store must grow
    occ, cents = eng.store["occupancy"], eng.store["centroids"]
    hot = int(torch.argmax(occ.sum(1)))
    near = torch.sort(((cents - cents[hot]) ** 2).sum(1), stable=True).indices[
        :mutable.PLACE_WINDOW]
    n_hot = int((~occ[near]).sum()) + 1000
    hot_x = (cents[hot].cpu().numpy()[None]
             + rng.normal(0, 1, (n_hot, d)) * 0.01 * std).astype(np.float32)
    hot_ids = np.arange(n_hot) + 2 * n
    cap1, epoch1 = eng.cfg.capacity, eng.epoch
    timed("insert (grow)", lambda: eng.insert(hot_x, hot_ids))
    r = eng.search(q, tier="f32")
    if eng.cfg.capacity < 1.5 * cap1 or eng.epoch != epoch1 + 1 or r.stats.cache_hit:
        raise AssertionError(f"churn growth: capacity {cap1} -> {eng.cfg.capacity}, epoch "
                             f"{epoch1} -> {eng.epoch}, cache hit {r.stats.cache_hit}")
    log(f"churn  (c) {n_hot} copies of partition {hot}'s centroid: capacity {cap1} -> "
        f"{eng.cfg.capacity}, epoch {epoch1} -> {eng.epoch}, the next search a cache miss; "
        f"insert {walls['insert (grow)'][0]:.3f} s")
    # a batch of 128 rows: the plain scan's [B, q_cap, capacity] distances
    # stay a few GB at the grown capacity
    for tier in ("f32", "residual_pq"):
        cuda_vs_ref(eng, q[:128], tier, f"churn  (c) grown {tier}")

    # (d) a forced repartition, then recall@100 over the live set
    timed("repartition", lambda: eng.maybe_repartition(force=True))
    alive = np.sort(order[n_dead:])
    live_x = np.concatenate([ds.base[alive], *new_x, hot_x])
    live_ids = np.concatenate([alive, *new_ids, hot_ids])
    if int(eng.store["occupancy"].sum()) < len(live_ids):
        raise AssertionError("churn: fewer live slots than live rows after the repartition")
    _, gti = gt.exact_knn(q, live_x, 100, device="cuda")
    gt_ids = live_ids[gti]
    recall = {t: recall_at_k(eng.search(q, tier=t).ids, gt_ids, 100)
              for t in ("f32", "residual_pq")}
    t0 = time.perf_counter()
    fresh = LiraEngine.build(live_x, BuildConfig(tier="residual_pq", **MAIN_BUILD), device="cuda")
    torch.cuda.synchronize()
    t_fresh = time.perf_counter() - t0
    fresh_rec = {}
    for t in ("f32", "residual_pq"):
        ids = fresh.search(q, tier=t).ids
        fresh_rec[t] = recall_at_k(np.where(ids >= 0, live_ids[ids], -1), gt_ids, 100)
    del fresh
    log(f"churn  (d) forced repartition {walls['repartition'][0]:.3f} s: capacity "
        f"{eng.cfg.capacity}, staleness {eng.staleness():.4f}; recall@100 over {len(live_ids)} "
        f"live rows at sigma {eng.sigma}: f32 {recall['f32']:.4f}, residual_pq "
        f"{recall['residual_pq']:.4f}; a fresh build of the live set ({t_fresh:.1f} s): f32 "
        f"{fresh_rec['f32']:.4f}, residual_pq {fresh_rec['residual_pq']:.4f}; gaps "
        f"{fresh_rec['f32'] - recall['f32']:+.4f} / "
        f"{fresh_rec['residual_pq'] - recall['residual_pq']:+.4f} (the reference's epsilon 0.02)")
    if recall["f32"] < 0.9:
        raise AssertionError(f"churn: f32 recall@100 {recall['f32']:.4f} < 0.9")

    # (e)
    log(f"churn  (e) wall seconds: " + ", ".join(
        f"{k} {sum(v):.3f} (x{len(v)})" for k, v in walls.items())
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{smi}; phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- mesh and cluster

SERVE_KERNELS = ("l2_topk_qbuf", "dedup_topk", "pq_adc_topk_qbuf")


class Calls:
    """While active, records every call of the serve kernels' dispatch
    wrappers (``kops.<name>``) as (name, args, kw), and passes it on."""

    def __enter__(self):
        from repro_torch.kernels import ops as kops

        self.calls, self.orig = [], {n: getattr(kops, n) for n in SERVE_KERNELS}
        for name, fn in self.orig.items():
            setattr(kops, name, self._wrap(name, fn))
        return self.calls

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            self.calls.append((name, args, kw))
            return fn(*args, **kw)
        return wrapped

    def __exit__(self, *exc):
        from repro_torch.kernels import ops as kops

        for name, fn in self.orig.items():
            setattr(kops, name, fn)


def hold_kernels(what, calls) -> dict:
    """Each serve kernel against its plain version on the inputs one batch
    gave it, once per distinct input shape, timed beside its bound. Returns
    {kernel: [{shape, max_abs_err, ms, plain_ms, bound_ms, bound_by}, ...]}."""
    from repro_torch.kernels import dedup_topk as dd_mod, l2_topk as l2_mod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pq_adc as adc_mod

    out, seen = {}, set()
    for name, args, kw in calls:
        kw = {n: v for n, v in kw.items() if n != "impl"}
        shape = tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))
        if (name, shape) in seen:
            continue
        seen.add((name, shape))
        if name == "l2_topk_qbuf":
            err = compare_l2(f"{what} l2_topk_qbuf {shape}", *args)
            kernel, bound = (lambda: l2_mod.l2_topk_qbuf(*args)), l2_bound(*args)
        elif name == "dedup_topk":
            err = compare_dedup(f"{what} dedup_topk {shape}", *args)
            pd, _, k = args
            kernel = lambda: dd_mod.dedup_topk(*args)  # noqa: E731
            bound = (pd.numel() * 8 + pd.shape[0] * k * 8, 0.0, PEAK_OPS["float32"])
        else:
            err = compare_adc(f"{what} pq_adc_topk_qbuf {shape}", *args, kw["cand_off"],
                              kw["q_off"])
            kernel = lambda: adc_mod.pq_adc_topk_qbuf(*args, **kw)  # noqa: E731
            bound = adc_bound(*args, kw["cand_off"], kw["q_off"])
        ms = time_ms(kernel, 10)
        plain_ms = time_ms(lambda: getattr(kops, name)(*args, **kw, impl="ref"), 2, 1)
        bound_ms, bound_by = bound_entry(*bound)
        out.setdefault(name, []).append({"shape": [list(s) for s in shape], "max_abs_err": err,
                                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                         "bound_by": bound_by})
        log(f"{what} kernel {name} at {shape}: equal to its plain version (max abs err "
            f"{err:.3g}); {ms:.3f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms by "
            f"{bound_by})")
    return out


def serve_batches(engine, queries, tier, **kw):
    """``len(queries) / BATCH`` batches through ``search``; returns the
    results and each batch's host seconds."""
    out, secs = [], []
    for s in range(0, len(queries), BATCH):
        t0 = time.perf_counter()
        out.append(engine.search(queries[s:s + BATCH], tier=tier, **kw))
        secs.append(time.perf_counter() - t0)
    return out, secs


def zeroed(counters):
    for mod in counters.values():
        mod.launches = 0


def read(counters):
    return {name: mod.launches for name, mod in counters.items()}


def mesh_phase(eng, ds, counters, smi) -> dict:
    """15. The main engine's 10 batches of 1,000 through a mesh of (data 1,
    model 4), every rank on the card, held against the unsharded search
    (f32 bit for bit; residual_pq at rerank 4 under the comparison rule,
    rows equal bit for bit counted; dedup_hits at most the unsharded count),
    with each rank's kernels launched and the three kernels held against
    their plain versions at the meshed shapes; impl="cuda" against "ref" on
    the meshed step; then (data 2, model 2), each half of a batch equal bit
    for bit to an unsharded search of that half; with two cards or more, a
    mesh of one rank a card under the same equalities. Returns the kernels'
    entries at the meshed shapes."""
    import numpy as np
    import torch

    from repro_torch import testing as rt
    from repro_torch.launch.mesh import make_test_mesh

    t_phase = time.perf_counter()
    q_all = ds.queries
    atol = rt.l2_atol(q_all, eng.store["vectors"], eng.store["ids"])
    solo = {t: serve_batches(eng, q_all, t) for t in ("f32", "residual_pq")}
    n_cards = torch.cuda.device_count()
    meshes = [("model 4, every rank on the card", make_test_mesh(1, 4, device="cuda"))]
    if n_cards >= 2:
        n = min(4, n_cards)
        meshes.append((f"model {n}, one rank a card",
                       make_test_mesh(1, n, devices=[f"cuda:{i}" for i in range(n)])))
        log(f"mesh   {n_cards} cards: the one-rank-a-card mesh runs too")
    else:
        log(f"mesh   {n_cards} card: every rank shares it; the one-rank-a-card mesh needs two "
            f"cards or more and did not run")
    entries = {}
    for what, mesh in meshes:
        m_eng = dataclasses.replace(eng, mesh=mesh)
        model_n = mesh.shape["model"]
        for tier in ("f32", "residual_pq"):
            zeroed(counters)
            got, secs = serve_batches(m_eng, q_all, tier)
            launches = read(counters)
            scan = "l2_topk_qbuf" if tier == "f32" else "pq_adc_topk_qbuf"
            n_b = len(got)
            if launches[scan] != model_n * n_b or launches["dedup_topk"] != (model_n + 1) * n_b:
                raise AssertionError(f"mesh {what} {tier}: launches {launches}")
            ref, ref_secs = solo[tier]
            n_bits = n_rows = 0
            err = 0.0
            hits = [0, 0]
            for a, b in zip(got, ref):
                if not (np.array_equal(a.nprobe_eff, b.nprobe_eff) and a.overflow == b.overflow):
                    raise AssertionError(f"mesh {what} {tier}: nprobe_eff / overflow differ")
                if a.stats.dedup_hits > b.stats.dedup_hits:
                    raise AssertionError(f"mesh {what} {tier}: dedup_hits above the unsharded")
                hits[0] += a.stats.dedup_hits
                hits[1] += b.stats.dedup_hits
                err = max(err, rt.assert_topk_match(a.dists, a.ids, b.dists, b.ids, atol,
                                                    what=f"mesh {what} {tier}"))
                bits = np.all(a.dists == b.dists, 1) & np.all(a.ids == b.ids, 1)
                n_bits += int(bits.sum())
                n_rows += len(bits)
            if tier == "f32" and n_bits != n_rows:
                raise AssertionError(f"mesh {what} f32: {n_rows - n_bits} rows not bit-equal")
            log(f"mesh   {what}, {tier}: {n_rows} rows, {n_bits} equal bit for bit to the "
                f"unsharded search, the rest within the rule (max abs err {err:.3g}, atol "
                f"{atol:.3g}); overflow equal; dedup_hits {hits[0]} sharded, {hits[1]} "
                f"unsharded; launches over {n_b} batches {launches}; median batch "
                f"{1e3 * float(np.median(secs)):.2f} ms meshed, "
                f"{1e3 * float(np.median(ref_secs)):.2f} ms unsharded; {smi}")
            if not entries:
                with Calls() as calls:
                    m_eng.search(q_all[:BATCH], tier="f32")
                    m_eng.search(q_all[:BATCH], tier="residual_pq")
                entries = hold_kernels("mesh  ", calls)
                del calls
        for tier in ("f32", "residual_pq"):
            cuda_vs_ref(m_eng, q_all[:BATCH], tier, f"mesh   {what}, {tier}")
    # data 2 x model 2: each batch row serves its half on its own
    m_eng = dataclasses.replace(eng, mesh=make_test_mesh(2, 2, device="cuda"))
    zeroed(counters)
    got, secs = serve_batches(m_eng, q_all, "f32")
    launches = read(counters)
    if launches["l2_topk_qbuf"] != 4 * len(got) or launches["dedup_topk"] != 6 * len(got):
        raise AssertionError(f"mesh data 2 x model 2: launches {launches}")
    half = m_eng._batch_bucket(BATCH) // 2
    for j, r in enumerate(got):
        qb = q_all[j * BATCH:(j + 1) * BATCH]
        for rows in (slice(0, half), slice(half, BATCH)):
            alone = eng.search(qb[rows], tier="f32")
            if not (np.array_equal(r.dists[rows], alone.dists)
                    and np.array_equal(r.ids[rows], alone.ids)):
                raise AssertionError(f"mesh data 2 x model 2: batch {j} rows {rows} differ")
    log(f"mesh   data 2 x model 2, f32: each half of each of the {len(got)} batches ({half} and "
        f"{BATCH - half} rows) equal bit for bit to an unsharded search of that half alone; "
        f"launches {launches}; median batch {1e3 * float(np.median(secs)):.2f} ms")
    log(f"mesh   phase {time.perf_counter() - t_phase:.1f} s")
    return entries


def cluster_phase(ds, counters, gti, recall, smi) -> dict:
    """16. A LiraCluster of 4 hash shards x 2 replicas over the 1M base, each
    shard a full lira-ann-q engine on the card: per tier its 10 batches,
    recall@100 against phase 4's ground truth (f32 >= 0.9), each batch equal
    bit for bit to dedup_topk_np of the shard engines' own searches; a
    replica killed mid-stream and one stalled (FakeClock, tick) leave every
    answer's bits; a whole dead group raises; the full fan-out exactness gate
    over 100,000 points against a union engine and exact ground truth; a
    front-end of 1,000 single-query requests. Returns the kernels' entries
    at one shard's shapes."""
    import numpy as np
    import torch

    from repro_torch import testing as rt
    from repro_torch.configs.base import FrontendConfig
    from repro_torch.core import ground_truth as gt
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.kernels.ref import dedup_topk_np
    from repro_torch.obs import Tracer
    from repro_torch.serving.api import BuildConfig, SearchRequest
    from repro_torch.serving.cluster import ClusterConfig, LiraCluster
    from repro_torch.serving.engine import LiraEngine
    from repro_torch.utils.clock import FakeClock

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    q_all = ds.queries
    build_s = []
    plain_build = LiraEngine.build.__func__

    def timed_build(cls, *args, **kw):
        t0 = time.perf_counter()
        out = plain_build(cls, *args, **kw)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        return out

    ccfg = ClusterConfig(n_shards=4, n_replicas=2, seed=0)
    # a shard's probing labels are the k nearest neighbours within its
    # training subset: at the single engine's train_frac a shard of a quarter
    # of the rows trains on a quarter as many, and its labels reach about
    # four times as far. Each shard trains on as many rows as the single
    # engine did (the last step logs the recall at the single engine's
    # fraction)
    shard_build = dict(MAIN_BUILD, train_frac=ccfg.n_shards * MAIN_BUILD["train_frac"])
    LiraEngine.build = classmethod(timed_build)
    try:
        cl = LiraCluster.build(ds.base, BuildConfig(tier="residual_pq", **shard_build), ccfg,
                               device="cuda")
    finally:
        LiraEngine.build = classmethod(plain_build)
    sizes = [len(g.row_ids) for g in cl.groups]
    stores = sum(t.numel() * t.element_size() for g in cl.groups
                 for t in g.engine.store.values()) / 2**30
    log(f"cluster built 4 hash shards x 2 replicas over {len(ds.base)} points (train_frac "
        f"{shard_build['train_frac']:g}): rows {sizes}, capacity "
        f"{[g.engine.cfg.capacity for g in cl.groups]}, build s "
        + ", ".join(f"{s:.1f}" for s in build_s)
        + f"; stores {stores:.3f} GiB on the card, {held:.3f} GiB held before the build")
    atol = max(rt.l2_atol(q_all, g.engine.store["vectors"], g.engine.store["ids"])
               for g in cl.groups)
    answers, rec = {}, {}
    for tier in ("f32", "residual_pq"):
        zeroed(counters)
        res, secs = serve_batches(cl, q_all, tier)
        launches = read(counters)
        scan = "l2_topk_qbuf" if tier == "f32" else "pq_adc_topk_qbuf"
        if launches[scan] != 4 * len(res) or launches["dedup_topk"] != 4 * len(res):
            raise AssertionError(f"cluster {tier}: launches {launches}")
        ids = np.concatenate([r.ids for r in res])
        rec[tier] = recall_at_k(ids, gti, 100)
        answers[tier] = res
        for j, r in enumerate(res):
            qb = q_all[j * BATCH:(j + 1) * BATCH]
            per = [g.engine.search(qb, tier=tier) for g in cl.groups]
            pool_i = np.concatenate([np.where(p.ids >= 0, g.row_ids[np.clip(p.ids, 0, None)], -1)
                                     for p, g in zip(per, cl.groups)], 1)
            d, i = dedup_topk_np(np.concatenate([p.dists for p in per], 1), pool_i, 100)
            if not (np.array_equal(r.dists, d) and np.array_equal(r.ids, i)):
                raise AssertionError(f"cluster {tier}: batch {j} differs from the host merge "
                                     f"of its shards")
        log(f"cluster {tier}: recall@100 {rec[tier]:.4f} against exact ground truth (one "
            f"engine over the 1M: {recall[tier]:.4f}); every batch equal bit for bit to "
            f"dedup_topk_np of the 4 shard engines' own searches; launches over {len(res)} "
            f"batches {launches}; median batch {1e3 * float(np.median(secs)):.2f} ms; routes of "
            f"the last {res[-1].stats.routes}; {smi}")
    # one batch a path with a Tracer on the cluster: the fan-out's shard
    # spans (each an engine search, ended after its synchronize) and the
    # host merge
    for tier in ("f32", "residual_pq"):
        cl.tracer = Tracer()
        traced = cl.search(q_all[:BATCH], tier=tier)
        spans, cl.tracer = cl.tracer, None
        if not same_bits(traced, answers[tier][0]):
            raise AssertionError(f"cluster {tier}: the traced batch differs")
        log(f"cluster {tier} one batch traced, equal bit for bit to the untraced one: "
            f"cluster.search {spans.finished('cluster.search')[0].duration_ms:.2f} ms = shards "
            + ", ".join(f"{sp.duration_ms:.2f}" for sp in spans.finished("cluster.shard"))
            + f" + cluster.merge {spans.finished('cluster.merge')[0].duration_ms:.2f} ms "
              f"(host, dedup_topk_np of [{BATCH}, {4 * 100}])")
    if len(ds.base) == N_BASE and rec["f32"] < 0.9:
        raise AssertionError(f"cluster f32 recall@100 {rec['f32']:.4f} < 0.9")
    with Calls() as calls:
        cl.groups[0].engine.search(q_all[:BATCH], tier="f32")
        cl.groups[0].engine.search(q_all[:BATCH], tier="residual_pq")
    entries = hold_kernels("cluster", calls)
    del calls

    # faults on a fresh control plane over the same engines, on a FakeClock,
    # per path. The kill is armed at batch 3 and fires at the next batch
    # routed to the replica (a power-of-two choice): the stream runs on,
    # batches again from the first, until it has
    for tier in ("f32", "residual_pq"):
        clock = FakeClock()
        fcl = LiraCluster([g.engine for g in cl.groups], [g.row_ids for g in cl.groups],
                          dataclasses.replace(ccfg, heartbeat_timeout_s=5.0), clock=clock)
        failovers = j = 0
        while j < 10 or (fcl.groups[0].router.replicas[0].healthy and j < 40):
            want = answers[tier][j % 10]
            if j == 3:
                fcl.fail_replica(0, 0, inflight=True)
            if j == 6:
                fcl.stall_replica(2, 1)
                clock.advance(10.0)
                if fcl.tick() != [(2, 1, 0)]:
                    raise AssertionError("cluster: the stalled replica was not failed by tick")
            r = fcl.search(q_all[(j % 10) * BATCH:(j % 10 + 1) * BATCH], tier=tier)
            failovers += r.stats.failovers
            if not (np.array_equal(r.dists, want.dists) and np.array_equal(r.ids, want.ids)):
                raise AssertionError(f"cluster faults {tier}: batch {j} differs")
            if r.stats.failovers:
                fired = j
            if (j >= 6 and r.stats.routes[2][1] != 0) or (failovers and r.stats.routes[0][1] != 1):
                raise AssertionError(f"cluster faults {tier}: batch {j} routed to a dead "
                                     f"replica: {r.stats.routes}")
            j += 1
        if failovers != 1 or fcl.groups[0].router.replicas[0].healthy:
            raise AssertionError(f"cluster faults {tier}: {failovers} failovers")
        fcl.fail_replica(3, 0)
        fcl.fail_replica(3, 1)
        try:
            fcl.search(q_all[:BATCH], tier=tier)
        except RuntimeError as exc:
            if "no healthy replicas" not in str(exc):
                raise
        else:
            raise AssertionError("cluster: a whole dead group served")
        served = {f"s{r['shard']}r{r['replica']}": r["served"] for r in fcl.replica_table()}
        log(f"cluster faults {tier}: replica (0, 0) armed to die at batch 3, killed with batch "
            f"{fired} in flight ({failovers} failover, replayed on replica 1), replica (2, 1) "
            f"stalled at batch 6 and failed by tick; all {j} batches equal bit for bit to the "
            f"healthy run, each routed around the dead; a whole dead group raises; served "
            f"{served}")

    # exactness gate: full fan-out over 100,000 points, every partition
    # scanned (sigma -1, nprobe_max = B), no probe dropped (q_cap = q_row)
    base = ds.base[:100_000]
    q = q_all[:BATCH]
    exact = BuildConfig(tier="f32", n_partitions=64, k=100, nprobe_max=64, eta=0.03, sigma=-1.0,
                        train_frac=0.1, q_cap_factor=1.0)
    xcl = LiraCluster.build(base, exact, dataclasses.replace(ccfg, n_replicas=1),
                            device="cuda")
    union = LiraEngine.build(base, exact, device="cuda")
    rc, ru = xcl.search(q), union.search(q)
    gtd, gt_i = gt.exact_knn(q, base, 100, device="cuda")
    if rc.overflow or ru.overflow:
        raise AssertionError(f"cluster exactness: overflow {rc.overflow} / {ru.overflow}")
    xatol = rt.l2_atol(q, torch.as_tensor(base), torch.zeros(len(base), dtype=torch.int32))
    err_u = rt.assert_topk_match(rc.dists, rc.ids, ru.dists, ru.ids, xatol,
                                 what="cluster vs union engine")
    err_g = rt.assert_topk_match(rc.dists, rc.ids, gtd, gt_i, xatol,
                                 what="cluster vs exact ground truth")
    bits = int((np.all(rc.dists == ru.dists, 1) & np.all(rc.ids == ru.ids, 1)).sum())
    x_rec = recall_at_k(rc.ids, gt_i, 100)
    log(f"cluster exactness gate (4 shards over {len(base)} points, B 64, sigma -1, q_cap = "
        f"q_row, f32; {len(q)} queries): against one engine over the union {bits} rows equal "
        f"bit for bit, the rest within the rule (max abs err {err_u:.3g}, atol {xatol:.3g}); "
        f"against exact ground truth within the rule (max abs err {err_g:.3g}), recall@100 "
        f"{x_rec:.4f}")
    del xcl, union

    # a front-end over the f32 cluster: q_cap = the bucket's rows
    # (q_cap_factor B / nprobe_max) in every shard, so nothing overflows
    fe_cl = LiraCluster([dataclasses.replace(g.engine, cfg=dataclasses.replace(
        g.engine.cfg, q_cap_factor=g.engine.cfg.n_partitions / g.engine.cfg.nprobe_max))
        for g in cl.groups], [g.row_ids for g in cl.groups], ccfg)
    q = q_all[2 * BATCH:3 * BATCH]
    solo = fe_cl.search(q, tier="f32")
    fe = fe_cl.attach_frontend(FrontendConfig(max_batch=1000), clock=time.monotonic)
    pend = []
    t0 = time.perf_counter()
    for row in q:
        pend.append(fe.submit(SearchRequest(queries=row, tier="f32")))
        fe.poll()
    fe.drain()
    wall = time.perf_counter() - t0
    st = fe.stats()
    fe_cl.frontend = None
    res = [p.result() for p in pend]
    if solo.overflow or any(r.stats.shed or r.overflow for r in res) or st.served != len(q):
        raise AssertionError(f"cluster front-end: {st}, solo overflow {solo.overflow}")
    n_bits = n_probe = 0
    err = 0.0
    for i, r in enumerate(res):
        if not np.array_equal(r.nprobe_eff, solo.nprobe_eff[i:i + 1]):
            n_probe += 1    # the probing MLP's bits moved a sigma near-tie
            continue
        err = max(err, rt.assert_topk_match(r.dists, r.ids, solo.dists[i:i + 1],
                                            solo.ids[i:i + 1], atol,
                                            what=f"cluster front-end row {i} vs solo"))
        n_bits += bool(np.array_equal(r.dists, solo.dists[i:i + 1])
                       and np.array_equal(r.ids, solo.ids[i:i + 1]))
    if n_probe > len(q) // 100:
        raise AssertionError(f"cluster front-end: {n_probe} rows probed other partitions")
    log(f"cluster front-end f32 (time.monotonic, max_batch {fe.max_batch}): {st.served} "
        f"single-query requests in {st.batches} batches, mean {st.mean_batch:.1f} rows; p50 "
        f"{st.p50_ms:.3f} ms, p99 {st.p99_ms:.3f} ms, {st.qps:.1f} QPS ({len(q) / wall:.1f} over "
        f"the submit loop's wall {wall:.3f} s); against one solo cluster search: {n_bits} rows "
        f"equal bit for bit, {len(q) - n_bits - n_probe} within the rule (max abs err "
        f"{err:.3g}), {n_probe} with another nprobe_eff")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del cl, fcl, fe_cl
    torch.cuda.empty_cache()

    # the same shards at the single engine's train_frac, f32 only
    narrow = LiraCluster.build(ds.base, BuildConfig(tier="f32", **MAIN_BUILD), ccfg,
                               device="cuda")
    res, _ = serve_batches(narrow, q_all, "f32")
    r_narrow = recall_at_k(np.concatenate([r.ids for r in res]), gti, 100)
    log(f"cluster at the single engine's train_frac {MAIN_BUILD['train_frac']:g}: f32 "
        f"recall@100 {r_narrow:.4f} (at {shard_build['train_frac']:g}: {rec['f32']:.4f}), "
        f"probes a query over the 4 shards "
        f"{float(np.mean([r.nprobe_eff.mean() for r in res])):.2f}, overflow "
        f"{sum(r.overflow for r in res)} (at {shard_build['train_frac']:g}: "
        f"{sum(r.overflow for r in answers['f32'])})")
    del narrow
    log(f"cluster peak device memory {peak:.2f} GiB; {smi}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return entries


# ---------------------------------------------------------------- evaluation, training, examples

EVAL_Q_BATCH = 128             # partition_topk's default block of queries
EVAL_CHECK_ROWS = 8            # rows of each small block held against the plain version
EVAL_PLAIN_SLICE = 16          # rows a plain call takes (see eval_phase)
SIGMA_ROUNDING = 1e-4          # p̂ within this of σ (or of the top p̂) may land either side
SERVE_ANN_RECALL = 0.65        # serve_ann's recall@10 floor (PERF.md §4, phase 19)


def eval_phase(eng, ds, gtd, gti) -> dict:
    """17. The host evaluation path over a PartitionStore view of the main
    engine's fresh store (its centroids, vectors, ids and the counts of its
    occupancy) and its first 1,000 queries: partition_topk at q_batch 128
    (l2_topk_qbuf over a dense dispatch buffer, its launches counted) and in
    one block of all 1,000 (the same answer); the kernel held against its
    plain version at the 128-query block (the plain answer taken in slices
    of 16 queries) and on two blocks of 8 queries, and timed beside its
    bound at the 128-query block; a full probe merged equal to exact ground
    truth;
    evaluate_probe of probe_lira(p̂, σ) query by query at least the serve
    path's f32 recall (the serve step probes a subset: it caps at
    nprobe_max and drops overflow), the queries where the two paths' p̂
    straddle σ within rounding counted; ids equal up to ties wherever the
    serve probes equal the evaluation mask; then IVF swept to LIRA's recall.
    Returns the kernel's JSON entry at the dense-dispatch shapes."""
    import numpy as np
    import torch

    from repro_torch import testing as rt
    from repro_torch.core import retrieval as ret
    from repro_torch.core.partitions import PartitionStore
    from repro_torch.kernels import l2_topk as l2_mod
    from repro_torch.kernels import ops as kops

    t_phase = time.perf_counter()
    k, n_q, sigma = eng.cfg.k, BATCH, eng.sigma
    st = eng.store
    ids = torch.where(st["occupancy"], st["ids"], -1)
    store = PartitionStore(centroids=st["centroids"], vectors=st["vectors"], ids=ids,
                           counts=st["occupancy"].sum(1).to(torch.int32))
    b = store.n_partitions
    q_np, gtd, gti = ds.queries[:n_q], gtd[:n_q], gti[:n_q]
    q = torch.as_tensor(q_np, device=store.vectors.device)
    atol = rt.l2_atol(q, store.vectors, ids)

    l2_mod.launches = 0
    t0 = time.perf_counter()
    ptk = ret.partition_topk(store, q_np, k)
    topk_s = time.perf_counter() - t0
    launches = l2_mod.launches
    want = -(-n_q // EVAL_Q_BATCH)
    if launches != want:
        raise AssertionError(f"eval   partition_topk launched l2_topk_qbuf {launches} times, "
                             f"not {want}")
    t0 = time.perf_counter()
    one = ret.partition_topk(store, q_np, k, q_batch=n_q)
    one_s = time.perf_counter() - t0
    same = np.array_equal(one.dists, ptk.dists) and np.array_equal(one.ids, ptk.ids)
    rt.assert_topk_match(one.dists, one.ids, ptk.dists, ptk.ids, atol,
                         what="eval   partition_topk in one block vs blocks of 128")
    if not (ptk.dists[..., 1:] >= ptk.dists[..., :-1]).all():
        raise AssertionError("eval   a partition's top-k is not ascending")
    log(f"eval   partition_topk of {n_q} queries x {b} partitions at k {k}: {launches} "
        f"launches of l2_topk_qbuf at q_batch {EVAL_Q_BATCH}, {topk_s:.3f} s wall with the "
        f"copies to the host ({ptk.dists.nbytes + ptk.ids.nbytes} B); in one block of {n_q}: "
        f"{one_s:.3f} s, {'equal bit for bit' if same else 'equal under the rule'}")
    del one

    # the kernel against its plain version on two blocks of 8 queries, each
    # one partly filled group of slots a partition (the plain version's
    # [B, S, C] distance block is 55 MB a query row at this capacity)
    err_small = 0.0
    for s0 in (0, EVAL_Q_BATCH):
        qp, qb = ret.dense_dispatch(q[s0:s0 + EVAL_CHECK_ROWS], b)
        err_small = max(err_small, compare_l2(f"eval   block of {EVAL_CHECK_ROWS} at query {s0}",
                                              qp, qb, store.vectors, ids, k))
    qp, qb = ret.dense_dispatch(q[:EVAL_Q_BATCH], b)
    ms = time_ms(lambda: l2_mod.l2_topk_qbuf(qp, qb, store.vectors, ids, k), 10)
    qp_all, qb_all = ret.dense_dispatch(q, b)
    ms_all = time_ms(lambda: l2_mod.l2_topk_qbuf(qp_all, qb_all, store.vectors, ids, k), 3)
    del qp_all, qb_all
    torch.cuda.empty_cache()

    # the plain version of the same function on the same 128 queries, in
    # slices of 16 (at 128 rows its distance block alone is 7 GB and its
    # sort several times that); the slices' [B, 16, k] answers side by side
    # are what the kernel's [B, 128, k] answer at the main path's shapes is
    # held to
    parts = []

    def plain():
        parts.clear()
        for s0 in range(0, EVAL_Q_BATCH, EVAL_PLAIN_SLICE):
            p, bq = ret.dense_dispatch(q[s0:s0 + EVAL_PLAIN_SLICE], b)
            parts.append(kops.l2_topk_qbuf(p, bq, store.vectors, ids, k, impl="ref"))
    plain_ms = time_ms(plain, 1, 1)
    d_p, i_p = (torch.cat([t[j] for t in parts], 1) for j in (0, 1))
    del parts
    torch.cuda.empty_cache()
    d_k, i_k = kops.l2_topk_qbuf(qp, qb, store.vectors, ids, k, impl="cuda")
    err = rt.assert_topk_match(d_k, i_k, d_p, i_p, rt.qbuf_atol(qp, qb, store.vectors, ids),
                               what=f"eval   l2_topk_qbuf vs its plain version at the dense "
                                    f"dispatch of {EVAL_Q_BATCH} queries")
    del d_k, i_k, d_p, i_p
    bound = bound_entry(*l2_bound(qp, qb, store.vectors, ids, k))
    pl = l2_mod.plan(qp, qb, store.vectors, ids, k)
    work = qbuf_item_work(pl["items"], ids)
    log(f"eval   kernel l2_topk_qbuf at the dense dispatch of {EVAL_Q_BATCH} queries (q_pad "
        f"{list(qp.shape)}, qbuf {list(qb.shape)}): equal to its plain version there (max abs "
        f"err {err:.3g}) and on 2 blocks of {EVAL_CHECK_ROWS} (max abs err {err_small:.3g}); "
        f"{ms:.3f} ms (plain {plain_ms:.3f} ms in slices of {EVAL_PLAIN_SLICE}, bound "
        f"{bound[0]:.3f} ms by {bound[1]}); all {n_q} in one block {ms_all:.3f} ms; "
        f"{work.numel()} work items, {pl['split_items']} split, heaviest "
        f"{100 * float(work.max() / work.sum()):.2f}%, workspace {pl['workspace_bytes']} B")
    entry = kernel_entry(
        "l2_topk_qbuf/partition_topk", "l2_topk_qbuf.cu", "src/repro/kernels/l2_topk.py:247",
        launches, err, ms, plain_ms, bound,
        {"q_pad": list(qp.shape), "qbuf": list(qb.shape), "cands": list(store.vectors.shape),
         "k": k, "occupied_slots": qb.numel(), "one_block_ms": ms_all,
         "one_block_rows": n_q, "plain_slice_rows": EVAL_PLAIN_SLICE,
         "small_blocks_rows": EVAL_CHECK_ROWS, "small_blocks_max_abs_err": err_small,
         "split_items": pl["split_items"], "heaviest_item_share": float(work.max() / work.sum())})
    del qp, qb, pl

    # a full probe is exact
    full = np.ones((n_q, b), bool)
    d_full, i_full = ret.merge_topk(ptk, full, k)
    err_full = rt.assert_topk_match(d_full, i_full, gtd, gti, atol,
                                    what="eval   full probe vs exact ground truth")
    r_full = ret.evaluate_probe(ptk, full, gti, k)
    log(f"eval   full probe: merge_topk equal to exact ground truth for all {n_q} queries (ids "
        f"up to ties at the {k}th place, max abs err {err_full:.3g}); recall@{k} "
        f"{r_full.recall:.4f}, cmp {r_full.cmp_mean:.1f}")

    # LIRA through the evaluation engine against the serve path, query by query
    with Calls() as calls:
        served = eng.search(q_np, tier="f32")
    (_, qbuf_s, _, _, _), _ = next((a, kw) for n, a, kw in calls if n == "l2_topk_qbuf")
    del calls
    slot_b, slot_s = torch.nonzero(qbuf_s < n_q, as_tuple=True)
    serve_mask = np.zeros((n_q, b), bool)
    serve_mask[qbuf_s[slot_b, slot_s].cpu().numpy(), slot_b.cpu().numpy()] = True
    cd = ret.lira_inputs(store, q_np)
    with torch.no_grad():
        p_hat = eng.model.probs(q, torch.as_tensor(cd, device=q.device)).cpu().numpy()
    mask = ret.probe_lira(p_hat, sigma)
    t0 = time.perf_counter()
    lira = ret.evaluate_probe(ptk, mask, gti, k)
    eval_s = time.perf_counter() - t0
    serve_rec = ret._count_hits(served.ids, np.ascontiguousarray(gti[:, :k])) / k
    near = ((np.abs(p_hat - sigma) <= SIGMA_ROUNDING)
            | (np.abs(p_hat - p_hat.max(1, keepdims=True)) <= SIGMA_ROUNDING))
    outside = serve_mask & ~mask
    lower = lira.per_query_recall < serve_rec
    straddled = lower & outside.any(1) & ((outside & ~near).sum(1) == 0)
    d_m, i_m = ret.merge_topk(ptk, mask, k)
    # any other query below the serve path's recall must hold the same
    # answer up to ties at the k-th place
    tied = np.flatnonzero(lower & ~straddled)
    rt.assert_topk_match(d_m[tied], i_m[tied], served.dists[tied], served.ids[tied], atol,
                         what=f"eval   queries {tied[:20].tolist()} below the serve path's "
                              f"recall with no p̂ straddling σ")
    log(f"eval   LIRA σ {sigma} on the evaluation engine: recall@{k} {lira.recall:.4f}, cmp "
        f"{lira.cmp_mean:.1f}, nprobe {lira.nprobe_mean:.3f} ({eval_s:.3f} s on the host); the "
        f"serve path's f32 recall on the same queries {float(serve_rec.mean()):.4f} (nprobe_eff "
        f"{float(served.nprobe_eff.mean()):.3f}, overflow {served.overflow}); query by query "
        f"at least the serve path's on {int((~lower).sum())} of {n_q}; below on "
        f"{int(straddled.sum())} where the serve step probed a partition whose p̂ is within "
        f"{SIGMA_ROUNDING} of σ or of the top p̂, and on {len(tied)} with the same answer up "
        f"to ties at the {k}th place; {int(outside.any(1).sum())} queries probed a partition "
        f"outside the mask, {int((mask & ~serve_mask).any(1).sum())} missed one inside it")
    eq = (serve_mask == mask).all(1)
    err_eq = rt.assert_topk_match(d_m[eq], i_m[eq], served.dists[eq], served.ids[eq], atol,
                                  what="eval   merge vs serve where the probes are equal")
    bits = int((np.all(d_m[eq] == served.dists[eq], 1) & np.all(i_m[eq] == served.ids[eq],
                                                                  1)).sum())
    log(f"eval   {int(eq.sum())} of {n_q} queries probe the same partitions on both paths: "
        f"ids equal up to ties (max abs err {err_eq:.3g}), {bits} rows equal bit for bit")

    # IVF to LIRA's recall (recall is monotone in nprobe, so bisection)
    lo, hi, res = 1, b, {}

    def ivf(n):
        if n not in res:
            res[n] = ret.evaluate_probe(ptk, ret.probe_ivf(cd, n), gti, k)
        return res[n]
    while lo < hi:
        mid = (lo + hi) // 2
        if ivf(mid).recall >= lira.recall:
            hi = mid
        else:
            lo = mid + 1
    at = ivf(lo)
    below = f"; at nprobe {lo - 1}: recall {ivf(lo - 1).recall:.4f}" if lo > 1 else ""
    log(f"eval   IVF reaches LIRA's recall@{k} {lira.recall:.4f} at nprobe {lo} (recall "
        f"{at.recall:.4f}, cmp {at.cmp_mean:.1f}{below}); LIRA's cmp "
        f"{lira.cmp_mean:.1f} saves {100 * (1 - lira.cmp_mean / at.cmp_mean):.1f}% of IVF's "
        f"distance computations ({len(res)} IVF points evaluated)")
    log(f"eval   phase {time.perf_counter() - t_phase:.1f} s")
    return entry


TRAIN_ROWS, TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 100_000, 400, 100, 250


def train_phase(eng, ds) -> None:
    """18. The probing model trained through the port's Trainer at the main
    engine's widths: 100,000 base rows, their nearest centroid among the
    engine's, exact k = 100 labels within the subset (as LiraEngine.build
    makes them), ProbingPipeline at global batch 512, AdamW on a cosine
    schedule. A run that fails after step 250's update and resumes from
    step 200's checkpoint ends equal bit for bit to an uninterrupted run of
    400 steps. Deterministic algorithms are on for the phase (cuBLAS's
    workspace is fixed at the top of this script)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core import ground_truth as gt
    from repro_torch.core import probing
    from repro_torch.core.kmeans import assign_points, centroid_distances
    from repro_torch.core.train_probing import make_train_step, train_state
    from repro_torch.data.pipeline import PipelineSpec, ProbingPipeline
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    dev = eng.device
    cents = eng.store["centroids"]
    b, k = cents.shape[0], eng.cfg.k
    xs = torch.as_tensor(ds.base[:TRAIN_ROWS], device=dev)
    part, _ = assign_points(xs, cents)
    _, sti = gt.exact_knn(xs, xs, k, exclude_self=True)
    lab = torch.zeros((len(xs), b), dtype=torch.float32, device=dev)
    rows = torch.arange(len(xs), device=dev).repeat_interleave(k)
    lab[rows, part.long()[torch.as_tensor(sti, device=dev).long()].reshape(-1)] = 1.0
    cd = centroid_distances(xs, cents)
    pipe = ProbingPipeline(PipelineSpec(global_batch=512, seed=0), ds.base[:TRAIN_ROWS],
                           cd.cpu().numpy(), lab.cpu().numpy())
    del lab, cd, sti
    log(f"train  labels for {len(xs)} rows in {time.perf_counter() - t_phase:.1f} s (mean "
        f"{float(pipe.labels.sum(1).mean()):.2f} kNN partitions a row)")
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def trainer(ckpt=None):
        model = probing.ProbingModel(probing.ProbingConfig(dim=xs.shape[1], n_partitions=b),
                                     generator=torch.Generator(dev).manual_seed(1), device=dev)
        tx = opt.AdamW(model.parameters(), opt.cosine_schedule(1e-3, 50, TRAIN_STEPS))
        return Trainer(make_train_step(model, tx), train_state(model, tx), pipe,
                       ckpt_manager=ckpt, ckpt_every=TRAIN_CKPT_EVERY, log_every=50)

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        gold, hist = trainer().run(TRAIN_STEPS)
        torch.cuda.synchronize()
        gold_s = time.perf_counter() - t0
        cm = CheckpointManager(ckpt_dir, keep=3)
        try:
            trainer(cm).run(TRAIN_STEPS, fail_at=TRAIN_FAIL_AT)
            raise AssertionError("train  the run did not fail")
        except RuntimeError as e:
            if "simulated failure" not in str(e):
                raise
        t2 = trainer(cm)
        resumed = t2.start_step
        if resumed != TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY:
            raise AssertionError(f"train  resumed at step {resumed}")
        state, hist2 = t2.run(TRAIN_STEPS)
    finally:
        torch.use_deterministic_algorithms(was)
    bad = [i for i, (a, c) in enumerate(zip(gold, state)) if not torch.equal(a, c)]
    if bad or [h["loss"] for h in hist] != [h["loss"] for h in hist2]:
        raise AssertionError(f"train  the resumed run differs from the uninterrupted one in "
                             f"leaves {bad}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"train  {TRAIN_STEPS} steps at global batch 512: {TRAIN_STEPS / gold_s:.1f} steps/s "
        f"({gold_s:.2f} s, host batches included); loss {hist[0]['loss']:.3f} at step "
        f"{hist[0]['step']} → {hist[-1]['loss']:.3f} at {hist[-1]['step']}; failed after step "
        f"{TRAIN_FAIL_AT}'s update, resumed at step {resumed}: all {len(state)} state "
        f"leaves and the loss history equal bit for bit to the uninterrupted run")
    log(f"train  phase {time.perf_counter() - t_phase:.1f} s")


def run_example(name, *args) -> str:
    """``python -m repro_torch.examples.<name>`` on the card; its output."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", *args],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    for line in out.stdout.splitlines():
        log(f"examples {name} | {line}")
    if out.returncode:
        raise AssertionError(f"examples {name} exited {out.returncode}: {out.stderr[-2000:]}")
    log(f"examples {name}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return out.stdout


def examples_phase() -> None:
    """19. The three LIRA examples as subprocesses on the card at their own
    sizes: serve_ann's recall@10 on both tiers at least SERVE_ANN_RECALL and
    within 0.02 of each other; quickstart's LIRA visiting no more points than
    IVF at matched recall; train_probing_model run twice, the second run
    resuming at step 600."""
    import re
    import shutil

    text = run_example("serve_ann")
    rec = [float(r) for r in re.findall(r"recall@10=([\d.]+)", text)]
    if len(rec) != 2 or min(rec) < SERVE_ANN_RECALL or abs(rec[0] - rec[1]) > 0.02:
        raise AssertionError(f"examples serve_ann: recall@10 {rec}")
    text = run_example("quickstart")
    cmp_ = {m: float(c) for m, c in re.findall(r"(LIRA|IVF) ?: recall=[\d.]+ cmp=(\d+)", text)}
    if len(cmp_) != 2 or cmp_["LIRA"] > cmp_["IVF"]:
        raise AssertionError(f"examples quickstart: cmp {cmp_}")
    ckpt = os.path.join(ROOT, "build", "chip_smoke_probe_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    for start in (0, 600):
        text = run_example("train_probing_model", "--ckpt-dir", ckpt)
        if f"starting at step {start} " not in text:
            raise AssertionError(f"examples train_probing_model: not started at step {start}")
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"examples serve_ann recall@10 {rec} (floor {SERVE_ANN_RECALL}), quickstart cmp "
        f"{cmp_}, train_probing_model resumed at step 600")


# ---------------------------------------------------------------- the LM substrate

LM_DENSE, LM_MOE = "stablelm-3b", "moonshot-v1-16b-a3b"
LM_PREFILL, LM_CACHE, LM_STEPS = (8, 2048), 4096, 64               # (a)
LM_GATE_LAYERS, LM_GATE_PREFILL, LM_GATE_STEPS = 2, (2, 256), 8    # (b), (c)
LM_MOE_LAYERS, LM_MOE_PREFILL, LM_MOE_STEPS = 4, (4, 2048), 32     # (d)
LM_MOE_GATE_PREFILL, LM_MOE_GATE_STEPS = (2, 64), 4
# card against CPU (f32, TF32 off: the same math summed in another order),
# and a decode step's logits against a prefill's on the card; the CPU tests
# hold the CPU path against JAX at SMOKE width to 5e-5
LM_F32_ATOL = 1e-3


def lm_configs():
    """(a)'s and (d)'s configurations: stablelm-3b whole, moonshot-v1-16b-a3b
    at its full width with its depth cut to LM_MOE_LAYERS (48 layers, 58 GB
    of bf16 weights, fill the card)."""
    from repro_torch.configs import get_config

    return (get_config(LM_DENSE)[0],
            dataclasses.replace(get_config(LM_MOE)[0], n_layers=LM_MOE_LAYERS))


def lm_weight_bytes(cfg, experts_read=None) -> float:
    """Weight bytes a decode step reads: every layer weight, the unembed and
    ln_f, the embed rows of the batch only (counted apart), and of the MoE
    experts ``experts_read`` (distinct routed experts summed over layers) or
    all of them."""
    from repro_torch.models import transformer as ttr

    specs = ttr.param_specs(cfg)
    leaves = {**{k: v for k, v in specs.items() if k not in ("layers", "embed")},
              **specs["layers"]}
    n = 0
    for name, spec in leaves.items():
        per = spec.numel()
        if name in ("wi_e", "wg_e", "wo_e") and experts_read is not None:
            per = per // (cfg.n_layers * cfg.moe.n_experts) * experts_read
        n += per
    return n * (2 if cfg.dtype == "bfloat16" else 4)


def lm_prefill_flops(cfg, b: int, s: int, kept_pairs=None, causal: bool = False) -> float:
    """What a prefill of [b, s] computes: every token's projections and
    FFN (MoE: the router, the shared experts and ``kept_pairs`` routed
    (token, expert) pairs summed over layers, else top_k a token), the
    attention of every KV block (the scan computes the masked ones too: s × s
    scores a sequence and head, and as many P·V products; with ``causal``
    only the s (s + 1) / 2 pairs the mask keeps) and the unembed of the last
    position. Multiply-adds count two."""
    d, t = cfg.d_model, b * s
    proj = d * cfg.n_heads * cfg.head_dim * 2 + d * cfg.n_kv_heads * cfg.head_dim * 2
    pairs_a_head = s * (s + 1) // 2 if causal else s * s
    attn = 4 * b * cfg.n_heads * pairs_a_head * cfg.head_dim
    if cfg.moe is None:
        ffn = cfg.n_layers * 2 * t * 3 * d * cfg.d_ff
    else:
        moe = cfg.moe
        pairs = kept_pairs if kept_pairs is not None else cfg.n_layers * t * moe.top_k
        ffn = (cfg.n_layers * 2 * t * (3 * d * moe.d_ff_expert * moe.n_shared + d * moe.n_experts)
               + 2 * pairs * 3 * d * moe.d_ff_expert)
    return cfg.n_layers * (2 * t * proj + attn) + ffn + 2 * b * d * cfg.vocab


def lm_profile(fn, top: int = 6):
    """One call of ``fn`` under torch.profiler: (wall ms, device busy ms,
    [(op, device ms, calls)] of the ``top`` operators by the device time of
    the kernels each launched itself). Busy is the kernels' time summed:
    an operator's device time is its kernels', so only one of the two is
    summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
    ops = [e for e in events if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return wall, busy, [(e.key, e.self_device_time_total / 1e3, e.count) for e in ops[:top]]


def lm_run(cfg, model, prefill_shape, steps: int, cache_len: int, dev, gen):
    """Prefill ``prefill_shape`` random tokens from ``gen``, copy the cache
    into one of ``cache_len`` positions, then greedy decode: once untimed
    (warm-up, routing counted), then timed from the same position.
    Returns the timings and counts; the outputs are checked here."""
    import torch

    from repro_torch.models import build_bundle
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.api import ShapeSpec
    from repro_torch.launch.mesh import make_test_mesh

    b, s = prefill_shape
    bundle = build_bundle(cfg, make_test_mesh(1, 1, device=dev))
    prefill = bundle.step(ShapeSpec("prefill", "prefill", {"seq_len": s, "global_batch": b})).fn
    decode = bundle.step(ShapeSpec("decode", "decode",
                                   {"seq_len": cache_len, "global_batch": b})).fn
    toks = torch.randint(1, cfg.vocab, (b, s), generator=gen, device=gen.device).to(dev)

    # the MoE dispatch's capacity, kept pairs and routed experts, counted in
    # the untimed runs only (each count waits for the card)
    routing = []
    dispatch = lm_layers.moe_dispatch_local

    def counted(x_all, router_w, e0, e_loc, top_k, capacity):
        out = dispatch(x_all, router_w, e0, e_loc, top_k, capacity)
        kept = out[2] < x_all.shape[0]
        routing.append((x_all.shape[0], capacity, int(kept.sum()), int(kept.any(-1).sum())))
        return out

    lm_layers.moe_dispatch_local = counted
    try:
        logits, cache = prefill(model, toks)                    # warm-up, counted
        prefill_routing, routing[:] = list(routing), []
        shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.head_dim)
        dcache = {n: torch.zeros(shape, dtype=c.dtype, device=dev) for n, c in cache.items()}
        for n in cache:
            dcache[n][:, :, :s] = cache[n]
        del cache
        first = logits.argmax(-1).to(torch.int32)[:, None]
        tok, warm = first, []
        for i in range(steps):
            nxt, dcache = decode(model, dcache, tok, s + i)
            warm.append(nxt)
            tok = nxt[:, None]
    finally:
        lm_layers.moe_dispatch_local = dispatch
    decode_routing = list(routing)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits2, cache = prefill(model, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del cache
    if not bool(torch.isfinite(logits).all()) or logits.shape != (b, cfg.vocab):
        raise AssertionError(f"lm prefill logits: shape {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    tok, step_s, timed = first, [], []
    for i in range(steps):
        t1 = time.perf_counter()
        nxt, dcache = decode(model, dcache, tok, s + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        timed.append(nxt)
        tok = nxt[:, None]
    warm, timed = torch.stack(warm), torch.stack(timed)
    if not bool(((timed >= 0) & (timed < cfg.vocab)).all()):
        raise AssertionError("lm decode: a token outside the vocabulary")
    # the path adds in a fixed order (no atomics): a rerun gives the same bits
    rerun_err = float((logits2 - logits).abs().max())
    if not torch.equal(warm, timed) or rerun_err != 0:
        raise AssertionError(
            f"lm {cfg.arch}: a rerun differs: decode tokens equal on "
            f"{100 * float((warm == timed).float().mean()):.1f}%, prefill logits by {rerun_err}")
    # where the time goes: one prefill and one decode step (at position s
    # again: the same write) under the profiler
    profiles = {"prefill": lm_profile(lambda: prefill(model, toks)),
                "decode step": lm_profile(lambda: decode(model, dcache, first, s))}
    return dict(prefill_s=prefill_s, step_s=step_s, profiles=profiles,
                prefill_routing=prefill_routing,
                decode_routing=decode_routing, same_tokens=float((warm == timed).float().mean()),
                logits_rerun_err=rerun_err)


def lm_report(what, cfg, prefill_shape, steps: int, cache_len: int, run: dict, smi) -> dict:
    """Log one configuration's times beside their bounds: prefill by its
    operations at the dense bf16 peak, decode by the bytes it must read
    (weights, the whole cache) at the memory rate. Beside each, the bound of
    the work the function needs rather than what the reference's algorithm
    does: the prefill's causal pairs only, the decode's valid cache prefix
    (positions ≤ pos, averaged over the steps)."""
    import numpy as np

    b, s = prefill_shape
    kept = sum(r[2] for r in run["prefill_routing"]) or None
    flops = lm_prefill_flops(cfg, b, s, kept)
    prefill_bound = flops / PEAK_OPS[cfg.dtype]
    causal_flops = lm_prefill_flops(cfg, b, s, kept, causal=True)
    experts = None
    if cfg.moe is not None:
        # routed experts a step, summed over layers, averaged over the steps
        per_step = [r[3] for r in run["decode_routing"]]
        experts = sum(per_step) / steps
    size = 2 if cfg.dtype == "bfloat16" else 4
    cache_bytes = 2 * cfg.n_layers * b * cache_len * cfg.n_kv_heads * cfg.head_dim * size
    decode_bytes = lm_weight_bytes(cfg, experts) + cache_bytes + b * cfg.d_model * size
    decode_bound = decode_bytes / HBM_BYTES_PER_S
    valid = s + (steps + 1) / 2                  # mean of pos + 1 over the steps
    prefix_bytes = decode_bytes - cache_bytes * (1 - valid / cache_len)
    step = float(np.median(run["step_s"]))
    out = dict(prefill_ms=1e3 * run["prefill_s"], prefill_tok_s=b * s / run["prefill_s"],
               prefill_bound_ms=1e3 * prefill_bound, prefill_tflop=flops / 1e12,
               prefill_causal_bound_ms=1e3 * causal_flops / PEAK_OPS[cfg.dtype],
               prefill_causal_tflop=causal_flops / 1e12,
               decode_step_ms=1e3 * step, decode_mean_ms=1e3 * float(np.mean(run["step_s"])),
               decode_tok_s=b / step, decode_bound_ms=1e3 * decode_bound,
               decode_gb=decode_bytes / 1e9,
               decode_prefix_bound_ms=1e3 * prefix_bytes / HBM_BYTES_PER_S,
               decode_prefix_gb=prefix_bytes / 1e9)
    log(f"{what} prefill [{b}, {s}]: {out['prefill_ms']:.1f} ms, {out['prefill_tok_s']:.0f} "
        f"tokens/s; bound {out['prefill_bound_ms']:.1f} ms by operations "
        f"({out['prefill_tflop']:.2f} TFLOP at {PEAK_OPS[cfg.dtype] / 1e12:.0f} TFLOP/s, every "
        f"KV block counted), causal bound {out['prefill_causal_bound_ms']:.1f} ms "
        f"({out['prefill_causal_tflop']:.2f} TFLOP, the kept pairs only); {smi}")
    log(f"{what} decode {steps} steps from position {s} in a {cache_len}-position cache: "
        f"median {out['decode_step_ms']:.2f} ms a step (mean {out['decode_mean_ms']:.2f}), "
        f"{out['decode_tok_s']:.0f} tokens/s; bound {out['decode_bound_ms']:.2f} ms by bytes "
        f"({out['decode_gb']:.2f} GB: weights, the whole cache, at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), valid-prefix bound "
        f"{out['decode_prefix_bound_ms']:.2f} ms ({out['decode_prefix_gb']:.2f} GB: weights, "
        f"positions <= pos); the timed run's tokens equal the warm-up's on "
        f"{100 * run['same_tokens']:.1f}%; {smi}")
    for name, (wall, busy, ops) in run["profiles"].items():
        log(f"{what} profile of one {name}: device busy {busy:.2f} of {wall:.2f} ms of wall "
            f"({100 * busy / wall:.1f}%); by op: "
            + ", ".join(f"{op} {ms:.2f} ms x{n}" for op, ms, n in ops))
        out[f"{name.split()[0]}_busy_ms"] = busy
    if cfg.moe is not None:
        pre = run["prefill_routing"]
        dec = run["decode_routing"]
        log(f"{what} MoE prefill: {pre[0][0]} tokens a layer, capacity {pre[0][1]}, "
            f"kept pairs a layer {[r[2] for r in pre]} of {pre[0][0] * cfg.moe.top_k} "
            f"(dropped {sum(pre[0][0] * cfg.moe.top_k - r[2] for r in pre)}); decode: "
            f"capacity {dec[0][1]}, dropped {sum(r[0] * cfg.moe.top_k - r[2] for r in dec)} "
            f"of {sum(r[0] * cfg.moe.top_k for r in dec)} pairs over {steps} steps, "
            f"{experts / cfg.n_layers:.1f} of {cfg.moe.n_experts} experts routed a layer "
            f"a step")
        out.update(capacity=pre[0][1], prefill_dropped=sum(pre[0][0] * cfg.moe.top_k - r[2]
                                                           for r in pre),
                   decode_dropped=sum(r[0] * cfg.moe.top_k - r[2] for r in dec))
    return out


def lm_gate(cfg, prefill_shape, steps: int, dev, what, *, against_prefill: bool) -> dict:
    """(b) The same f32 parameters on the card and on the CPU: prefill
    logits within LM_F32_ATOL and the same token at every greedy decode step
    (the card fed the CPU's tokens). (c) with ``against_prefill``: each
    decode token on the card equal to the argmax of a card prefill over the
    prompt and the tokens before it, wherever that prefill's top-2 margin
    exceeds 2 · LM_F32_ATOL (the others counted)."""
    import copy

    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as ttr

    t0 = time.perf_counter()
    b, s = prefill_shape
    card = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    cpu = copy.deepcopy(card).to("cpu")
    toks = torch.randint(1, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(2))
    shape = (cfg.n_layers, b, s + steps, cfg.n_kv_heads, cfg.head_dim)
    sides = {}
    for side, model, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        mesh = make_test_mesh(1, 1, device=d)
        logits, cache = ttr.make_prefill_step(cfg, mesh)(model, toks.to(d))
        full = {n: torch.zeros(shape, dtype=c.dtype, device=d) for n, c in cache.items()}
        for n in cache:
            full[n][:, :, :s] = cache[n]
        sides[side] = [logits.cpu(), full, ttr.make_decode_step(cfg, mesh, b, s + steps), model, d]
    err = float((sides["card"][0] - sides["cpu"][0]).abs().max())
    if err > LM_F32_ATOL:
        raise AssertionError(f"{what}: card prefill logits differ from the CPU's by {err}")
    tok, chain = sides["cpu"][0].argmax(-1).to(torch.int32)[:, None], []
    for i in range(steps):
        got = {}
        for side, (_, cache, decode, model, d) in sides.items():
            got[side], _ = decode(model, cache, tok.to(d), s + i)
        if not torch.equal(got["card"].cpu(), got["cpu"]):
            raise AssertionError(f"{what}: decode step {i}: card {got['card'].tolist()} != "
                                 f"cpu {got['cpu'].tolist()}")
        chain.append(tok)
        tok = got["cpu"][:, None]
    chain.append(tok)
    out = dict(logits_err=err, steps=steps, batch=b)
    log(f"{what}: card = CPU, prefill [{b}, {s}] logits max abs err {err:.3g} (tolerance "
        f"{LM_F32_ATOL}), {steps} greedy decode steps equal token for token "
        f"({time.perf_counter() - t0:.1f} s)")
    if against_prefill:
        # prompt + the tokens decoded before step i -> the argmax must be
        # step i's token (chain[i + 1])
        prefill = ttr.make_prefill_step(cfg, make_test_mesh(1, 1, device=dev))
        checked = unsure = 0
        for i in range(1, steps + 1):
            ext = torch.cat([toks] + [t.cpu().long() for t in chain[:i]], 1).to(dev)
            logits, _ = prefill(card, ext)
            top2 = logits.topk(2, -1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * LM_F32_ATOL
            agree = logits.argmax(-1).cpu() == chain[i][:, 0].cpu().long()
            if not bool(agree[clear.cpu()].all()):
                raise AssertionError(f"{what}: decode step {i - 1} differs from a prefill of "
                                     f"{s + i} tokens")
            checked += int(clear.sum())
            unsure += int((~clear).sum())
        log(f"{what}: prefill = decode on the card: {checked} decoded tokens equal a prefill's "
            f"argmax, {unsure} left unchecked (top-2 margin within {2 * LM_F32_ATOL})")
        out.update(checked=checked, unsure=unsure)
    return out


def lm_phase(smi, dev="cuda") -> dict:
    """20. The LM substrate's serving path on the card: (a) stablelm-3b
    whole, timed; (b) card = CPU and (c) prefill = decode at its width and 2
    layers in f32; (d) moonshot-v1-16b-a3b's width at LM_MOE_LAYERS layers,
    timed, and its card = CPU gate at 2 layers."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models import layers as lm_layers

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dense, moe = lm_configs()
    found = {}
    for what, cfg, pshape, steps, cache_len in (
            ("lm     dense", dense, LM_PREFILL, LM_STEPS, LM_CACHE),
            ("lm     moe", moe, LM_MOE_PREFILL, LM_MOE_STEPS, LM_MOE_PREFILL[1] + LM_MOE_STEPS)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        model = build_bundle(cfg, make_test_mesh(1, 1, device=dev)).init(gen)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        if n != cfg.param_count:
            raise AssertionError(f"{what}: {n} parameters, the config counts {cfg.param_count}")
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        log(f"{what} {cfg.arch}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads x "
            f"{cfg.head_dim} (kv {cfg.n_kv_heads}), vocab {cfg.vocab}, {cfg.dtype}: "
            f"{n / 1e9:.3f} B parameters, {nbytes / 1e9:.2f} GB, drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        run = lm_run(cfg, model, pshape, steps, cache_len, dev, gen)
        res = lm_report(what, cfg, pshape, steps, cache_len, run, smi)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"{what} peak device memory {res['peak_gib']:.2f} GiB; a rerun's prefill logits "
            f"within {run['logits_rerun_err']:.3g} of the first's")
        if cfg.moe is None:
            # a logged reference: one layer's attention through the block
            # scan and through PyTorch's fused attention, same inputs
            b, s = pshape
            g = torch.Generator(device=dev).manual_seed(3)
            q, k, v = (torch.randn((b, s, cfg.n_heads, cfg.head_dim), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(3))
            block = min(cfg.attn_block, s)
            scan_ms = time_ms(lambda: lm_layers.flash_attention(q, k, v, causal=True,
                                                                block=block), 3, 1)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True).transpose(1, 2)
            sdpa_ms = time_ms(sdpa, 3, 1)
            diff = float((lm_layers.flash_attention(q, k, v, causal=True, block=block).float()
                          - sdpa().float()).abs().max())
            log(f"{what} one layer's attention [{b}, {s}, {cfg.n_heads}, {cfg.head_dim}] bf16: "
                f"the block scan {scan_ms:.3f} ms, scaled_dot_product_attention {sdpa_ms:.3f} "
                f"ms (a reference only; max abs difference {diff:.3g})")
            res.update(attention_scan_ms=scan_ms, attention_sdpa_ms=sdpa_ms)
            del q, k, v
        found[what.split()[-1]] = res
        del model
        torch.cuda.empty_cache()
    gate_dense = dataclasses.replace(dense, n_layers=LM_GATE_LAYERS, dtype="float32")
    found["dense_gate"] = lm_gate(gate_dense, LM_GATE_PREFILL, LM_GATE_STEPS, dev,
                                  "lm     dense gate", against_prefill=True)
    gate_moe = dataclasses.replace(moe, n_layers=LM_GATE_LAYERS, dtype="float32")
    found["moe_gate"] = lm_gate(gate_moe, LM_MOE_GATE_PREFILL, LM_MOE_GATE_STEPS, dev,
                                "lm     moe gate", against_prefill=False)
    torch.cuda.empty_cache()
    log(f"lm     phase {time.perf_counter() - t_phase:.1f} s; {smi}")
    return found


# ---------------------------------------------------------------- phases

def main(n_base: int = N_BASE, n_queries: int = N_QUERIES) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from repro_torch import testing as rt
    from repro_torch.configs.lira_ann import CONFIG_QUANTIZED
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
    # one seed, one index: a second build must be equal bit for bit
    twin = LiraEngine.build(pq_base, BuildConfig(tier="pq", **MAIN_BUILD), device="cuda")
    params = list(zip(eng_pq.model.named_parameters(), twin.model.named_parameters()))
    bad = ([n for (n, a), (_, b) in params if not torch.equal(a, b)]
           + [n for n in eng_pq.store if not torch.equal(eng_pq.store[n], twin.store[n])])
    if bad or twin.cfg != eng_pq.cfg:
        raise AssertionError(f"pq: two builds from one seed differ in {bad}")
    log(f"pq     a second build from the same seed: all {len(params)} probing parameters and "
        f"{len(eng_pq.store)} store planes ({', '.join(eng_pq.store)}) equal bit for bit")
    del twin
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
    # the scan's work items (G occupied slots of one bucket, or one candidate
    # range of a heavy group), from its own plan kernel: the heaviest item's
    # share of the work bounds what the other SMs can hide
    shape = l2_mod.occupancy(vec, k)
    pl = l2_mod.plan(qp, qb, vec, ids, k)
    work = qbuf_item_work(pl["items"], ids)
    log(f"kernel l2_topk_qbuf launch shape at k {k}: {shape} (d {vec.shape[2]}, {vec.dtype})")
    log(f"kernel l2_topk_qbuf work items (occupied slots x valid candidates): {work.numel()}, "
        f"{pl['split_items']} of them candidate ranges of split groups; max {int(work.max())}, "
        f"mean {float(work.mean()):.0f}, heaviest item {100 * float(work.max() / work.sum()):.2f}%"
        f" of the total {pl['total_work']}; partial lists {pl['partial_lists']} of the pool's "
        f"{pl['pool_lists']}; workspace {pl['workspace_bytes']} B; max occupied slots a bucket "
        f"{int(rt.occupied(qp, qb).sum(1).max())}, max valid candidates "
        f"{int((ids >= 0).sum(1).max())}")
    # what the empty slots cost: the same launch with every slot empty
    qb_empty = torch.full_like(qb, qp.shape[0] - 1)
    ms_empty = time_ms(lambda: l2_mod.l2_topk_qbuf(qp, qb_empty, vec, ids, k), 10)
    log(f"kernel l2_topk_qbuf with every one of the {qb.numel()} slots empty (inf / -1 "
        f"written, nothing scanned): {ms_empty:.3f} ms at k {k}")
    del qb_empty
    # the same inputs in a store padded to the configuration's capacity: the
    # same results, and what the padding costs
    cap = CONFIG_QUANTIZED.capacity
    big = vec.new_zeros((vec.shape[0], cap, vec.shape[2]))
    big[:, :vec.shape[1]] = vec
    big_ids = ids.new_full((ids.shape[0], cap), -1)
    big_ids[:, :ids.shape[1]] = ids
    same = all(torch.equal(a, b) for a, b in zip(l2_mod.l2_topk_qbuf(qp, qb, big, big_ids, k),
                                                 l2_mod.l2_topk_qbuf(qp, qb, vec, ids, k)))
    if not same:
        raise AssertionError(f"l2_topk_qbuf: a store padded to capacity {cap} changed the result")
    ms_big = time_ms(lambda: l2_mod.l2_topk_qbuf(qp, qb, big, big_ids, k), 10)
    pl_big = l2_mod.plan(qp, qb, big, big_ids, k)
    log(f"kernel l2_topk_qbuf over the store padded to capacity {cap}: equal bit for bit, "
        f"{ms_big:.3f} ms (at {vec.shape[1]}: {ms:.3f}); {len(pl_big['items'])} items, "
        f"workspace {pl_big['workspace_bytes']} B")
    del big, big_ids
    torch.cuda.empty_cache()  # the padded store's 34 GB go back to the card
    kernels[-1]["shapes"].update(launch=shape, all_empty_ms=ms_empty,
                                 heaviest_item_share=float(work.max() / work.sum()),
                                 split_items=pl["split_items"], padded_capacity=cap,
                                 padded_ms=ms_big)
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
    # the same kernel at the rerank-16 path's stage 1 (rk = 1,600)
    deep_in, _ = inputs["residual_pq rerank 16"]
    (lut16, qb16, codes16, slots16, rk16), kw16 = deep_in["pq_adc_topk_qbuf"]
    c16, q16 = kw16["cand_off"], kw16["q_off"]
    err16 = compare_adc("pq_adc_topk_qbuf rerank-16 inputs", lut16, qb16, codes16, slots16, rk16,
                        c16, q16)
    ms16 = time_ms(lambda: adc_mod.pq_adc_topk_qbuf(lut16, qb16, codes16, slots16, rk16,
                                                     cand_off=c16, q_off=q16), 10)
    bound16 = bound_entry(*adc_bound(lut16, qb16, codes16, slots16, rk16, c16, q16))
    log(f"kernel pq_adc_topk_qbuf at the rerank-16 path's stage 1 (k {rk16}): equal to its "
        f"plain version (max abs err {err16:.3g}); {ms16:.3f} ms (bound {bound16[0]:.3f} ms "
        f"by {bound16[1]})")
    kernels[-1]["shapes"]["rerank16"] = {"k": rk16, "ms": ms16, "bound_ms": bound16[0],
                                         "bound_by": bound16[1]}
    for k_ in (rk, rk16):
        log(f"kernel pq_adc_topk_qbuf launch shape at k {k_}: "
            f"{adc_mod.occupancy(lut, codes, k_)} (m {codes.shape[2]}, ks {lut.shape[2]}, "
            f"{codes.dtype})")
    # what the empty blocks cost: the same launch with every slot empty
    qb_empty = torch.full_like(qb, lut.shape[0] - 1)
    ms_empty = time_ms(lambda: adc_mod.pq_adc_topk_qbuf(lut, qb_empty, codes, slots, rk,
                                                         cand_off=coff, q_off=qoff), 10)
    log(f"kernel pq_adc_topk_qbuf with every one of the {qb.numel()} slots empty (inf / -1 "
        f"written, nothing scanned): {ms_empty:.3f} ms at k {rk}")
    kernels[-1]["shapes"]["all_empty_ms"] = ms_empty
    del qb_empty
    # one block takes one group of G slots of one bucket
    g = adc_mod.occupancy(lut, codes, rk)["slots_per_block"]
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

    # 10-12. the ADC trio: the full matrix, the exhaustive PQ search, the
    # residual_pq path's dispatch buffer expanded
    entry, (lut_q, codes_q, full) = adc_full_phase(dev, ds.queries[:BATCH], ds.base)
    kernels.append(entry)
    kernels.append(adc_flat_phase(dev, lut_q, codes_q, full, gti, 100))
    del lut_q, codes_q, full
    (lut, qb, codes, slots, rk), kw = res_in["pq_adc_topk_qbuf"]
    kernels.append(adc_batched_phase(lut, qb, codes, slots, rk, kw["cand_off"], kw["q_off"]))
    # the captured serve-path operands hold the store's planes: let them go
    # before the store is mutated and reshaped
    del (qp, qb, vec, ids, pd, pi, lut, codes, slots, kw, coff, qoff, lut16, qb16, codes16,
         slots16, kw16, c16, q16, res_in, deep_in, f32_in, inputs, captured)
    torch.cuda.empty_cache()

    # 13. the serve surface; 15. the mesh; 17. the evaluation path and 18.
    # the trainer over the fresh store; 14. churn on the main engine; 16. the
    # cluster, after the main engine is freed; 19. the examples
    t0 = time.perf_counter()
    serve_surface_phase(eng, deep, eng_pq, ds)
    del eng_pq, deep, engine    # engine: phase 4's loop variable, the last path's (deep)
    log(f"surface phase {time.perf_counter() - t0:.1f} s")
    meshed = mesh_phase(eng, ds, counters, smi)
    kernels.append(eval_phase(eng, ds, gtd, gti))
    train_phase(eng, ds)
    churn_phase(eng, ds, counters, smi)
    del eng
    torch.cuda.empty_cache()
    clustered = cluster_phase(ds, counters, gti, recall, smi)
    examples_phase()
    lm_phase(smi)
    for kern in kernels:
        for path, found in (("mesh", meshed), ("cluster", clustered)):
            if kern["name"] in found:
                kern["shapes"][path] = found[kern["name"]]

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
