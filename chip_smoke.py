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
                               no quantized stage launched;
                 residual_pq — recall@100 at lira-ann-q's rerank 4 (≥ 0.85),
                               and again at rerank 16, where it must be
                               ≥ 0.9 and within 0.03 of the f32 path's;
                               pq_adc_topk_qbuf, rerank_topk_qbuf and
                               dedup_topk launched;
               then one batch per path served again with impl="ref" must
               agree;
  5. pq      — a second engine with tier pq at 100,000 base points (same
               widths), built twice from one seed (every probing parameter
               and store plane equal bit for bit): launches (the ADC scan,
               the rerank and dedup_topk), recall@100
               against its own f32 tier, and cuda vs ref;
  6. kernels — each kernel against its plain version on the inputs the main
               paths gave it, timed with CUDA events beside its bound;
               l2_topk_qbuf also with every dispatch slot empty and over
               the store padded to lira-ann-q's capacity of 65,536 (equal
               bit for bit), its launch shape (slots a group, shared memory,
               blocks an SM) and how its work spreads over its work items
               (the heaviest item's share); pq_adc_topk_qbuf also at the rerank-16 path's stage 1
               (rk = 1,600) and with every dispatch slot empty, and its
               launch shape at both rk; rerank_topk_qbuf at both paths'
               stage 2 (rk = 400 and 1,600), carried in phase 27's entry;
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
               four serve kernels launched), compact(), the same batches
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
               rank (residual_pq: the ADC scan and the rerank) and dedup_topk
               once a rank plus once to merge across ranks; the four serve
               kernels held against their plain
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
               dedup_topk_np of the shard engines' own searches, the scan
               (residual_pq: the ADC scan and the rerank) and dedup_topk
               launched once a shard; the four serve kernels held against
               their plain versions at a shard's shapes; a replica
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
 21. lmtrain — after 20: LM training through build_bundle(...).step(train
               shape) and the port's Trainer (TokenPipeline batches): (a)
               stablelm-3b whole (bf16, remat full) at train_4k's sequence of
               4,096 and the largest batch that fits (8 of 256), a warm-up
               and two timed steps: ms a step and tokens/s beside the bound
               by operations (8·N·T and the scan's attention four times, at
               the bf16 peak) and the bound with the attention's f32
               products on the CUDA cores, peak memory, every step's loss
               and grad_norm finite; where a step goes (one layer's block
               scan forward and forward + backward, the loss, AdamW's
               update, timed alone); (a') one step at grad_accum 2 over
               [16, 4096], its peak beside (a)'s; (b) moonshot-v1-16b-a3b's
               width at 4 layers with its logits_chunk 8, [2, 4096], timed
               as (a), with the capacity and dropped pairs; (c) at 2 layers
               of each width in f32, one step on the card and the CPU from
               one set of parameters (metrics and updated parameters within
               1e-4), remat none = full = dots bit for bit on the card,
               logits_chunk 8 and (dense) grad_accum 4 within 1e-4 of their
               bases; (d) in bf16 at 2 layers, a step run twice equal bit
               for bit (dense and MoE), and a dense Trainer failed after
               step 3 resumed from its step-2 checkpoint equal bit for bit
               to an uninterrupted run; (e) python -m
               repro_torch.launch.train at stablelm-3b's SMOKE config failed
               at step 55, restarted (from step 50) to 60, its last
               checkpoint byte-equal to an uninterrupted run's, and python
               -m repro_torch.examples.lm_pretrain (200 steps, its loss
               falls).
 22. recsys  — after 21, on a freed card: deepfm, autoint, mind and
               dlrm-rm2, each (a) at its full CONFIG (1,000,000 ids a field)
               through build_bundle(get_config(...), make_test_mesh(1, 1))
               with data/smoke's recsys inputs: serve_p99 [512], serve_bulk
               [262,144] and retrieval_cand (1,000,000 candidates scored in
               chunks of 65,536, the top 100), each timed after an untimed
               run it must equal bit for bit, then train_batch [65,536]: a
               warm-up and two timed steps, losses and grad_norms finite;
               ms and examples/s beside the bound (the larger of the bytes
               at 3.35 TB/s and the operations at 67 TFLOP/s f32), peak
               memory; dlrm-rm2's step taken apart (forward + backward, the
               clip, AdamW); (b) at full widths with vocab_per_field
               100,000, one set of parameters on the card and the CPU:
               serve scores of 512 within 1e-5, retrieval over 100,000
               candidates (top-100 values within 1e-5, ids equal up to
               ties), one train step of 4,096 (updated parameters within
               1e-4, loss and grad_norm within 1e-4 of max(1, |value|));
               (c) that step run twice on the card
               equal bit for bit; (d) python -m repro_torch.launch.train at
               deepfm's and dlrm-rm2's SMOKE configs failed at step 55 and
               restarted to 60, the last checkpoint byte-equal to an
               uninterrupted run's.
 23. graph   — after 22: DimeNet's CONFIG (6 blocks, hidden 128, bilinear 8,
               spherical 7, radial 6, remat full) on full_graph_sm and
               molecule from build_graph_batch: real and padded edges and
               triplets, a warm-up and three timed steps, ms a step and
               triplets/s beside the bound by operations, peak memory,
               losses finite, one step profiled (device busy, top
               operators); (b) one step on molecule card = CPU within 1e-4
               (the metrics of max(1, |value|)); (c) on the card remat
               none = full and a step run twice, bit for bit. minibatch_lg and ogb_products are not
               run: the reference's data path forms an [N, N, 3] array
               (347 GB at 169,984 nodes).
 24. meshes  — after 23: the meshed models, every rank on the one card:
               (a) stablelm-3b whole, decode over 1 x 4 and 2 x 2 from one
               [8] x 4,096-position cache, fed the unsharded decode's
               tokens: its tokens wherever the top-2 margin is clear, the
               rest counted, ms a step against the unsharded step; (b)
               moonshot's width at 4 layers over 1 x 4 and 2 x 2, MoE
               gather and a2a: prefill [4, 2048], 16 decode steps, one
               train step at [2, 4096], each rank's dropped pairs and ms
               against the unsharded steps, and the same meshed steps at 2
               layers in f32 card = CPU (gather over 1 x 4, a2a over 2 x
               2); (c) dlrm-rm2 and mind whole (1M
               ids a field) over 1 x 4: serve_bulk equal to the unsharded
               scores bit for bit, one train step at 65,536 within 1e-4 of
               max(1, |value|), each rank's table slice and the peak; (d)
               DimeNet on full_graph_sm over 2 x 2: one train step, card =
               CPU within 1e-4 (the gap to the one-rank step logged: the
               reference's meshed edge gather is another function); (e)
               compressed_psum_pod over a 2-pod mesh on (b)'s gradients:
               the error buffers hold x - deq exactly.
 25. last    — after 24, the last modules: (a) a bf16_toy tier (the f32
               scan over a bfloat16 vector plane) registered here with
               tiers.register, outside the package, built over phase 4's
               1,000,000 points with lira-ann-q's recipe and serving its
               10,000 queries in batches of 1,000 through the unchanged
               engine: the config's and the stats' tier, a bf16 plane, the
               bf16 l2_topk_qbuf launched, recall@100 at least 0.9 and
               within 0.01 of phase 4's f32, one batch impl="cuda" = "ref";
               the kernel on the bf16 plane held against its plain version
               and timed beside its bound (the kernels line's
               l2_topk_qbuf/bf16); (b) the autotuner's sweep of G, the
               dispatch slots a block, at lira-ann-q's store shape: the L2
               scan over that serve path's dispatch buffer in f32 and bf16,
               the ADC scan (m 16, ks 256, rk 400) on synthetic operands of
               the store's shape, and the dense dispatch of partition_topk
               (128 queries to every partition): every G that fits gives the
               calculator's launch's bits, each G's time logged, the winner
               cached; (c) the dry run over one device (meta tensors) of
               phase 21's stablelm-3b train step [8, 4096] and phase 22's
               dlrm-rm2 train_batch [65,536]: its predicted peak within
               LAST_DRYRUN_BAND of the card's torch.cuda.max_memory_allocated
               from those phases, its counted FLOPs beside model_flops and
               the phases' own bound models.
 26. u8      — after 14, on a freed card, before 16: the u8 tier at
               bigann-u8's deployment (lirabench/configs/bigann-u8.json, the
               file the benchmark's cell runs: 4,000,000 uint8 rows of the
               SIFT-shaped mixture at d 128, B 1,024, k 100), built on the
               card; one batch of 8,192 uint8 queries through search() with
               the launch counters zeroed just before: l2u8_topk_qbuf and
               dedup_topk launched once, the f32 scan not at all; every
               returned distance the integer sum of squares of its row;
               recall@100 (a row at the exact 100th distance or nearer
               counts) at least the configuration's limit; the byte scan on
               the batch's operands equal bit for bit to its plain version
               (int64) on the occupied slots, inf / -1 on the empty ones, and
               to the f32 scan over the rows cast to f32; timed beside its
               bound at the INT8 tensor-core rate and with every slot empty.
 27. rerank  — after 26, on a freed card: the quantized tiers' exact rerank
               at lira-ann-q's deployment (lirabench/configs/lira-ann-q.json,
               the file the benchmark's cell runs: 2,000,000 rows at d 128,
               B 1,024, residual PQ m 16, ks 256, rerank 4, k 100), built on
               the card; one batch of 8,192 queries through search() with the
               launch counters zeroed just before: pq_adc_topk_qbuf,
               rerank_topk_qbuf and dedup_topk launched once, the f32 scan
               not at all; the rerank on the batch's operands held against
               its plain version (distances under l2_atol, ids equal up to
               ties at the k-th place, the rows equal element for element
               counted), inf / -1 on the empty slots, two runs equal bit for
               bit; timed beside its bound (each distinct shortlisted row
               read once, each occupied slot's shortlist, query and list),
               beside the plain version and with every slot empty.
Phases 20-24 launch none of the kernels: the LM's attention is the
reference's plain block scan, its loss and optimizer plain XLA, the recsys
family's embedding bag a gather and sum and DimeNet's message passing
segment sums, and no Pallas kernel lies on their path.
Phases 7-12, 15-17 and 25-27 zero the launch counters just before each path and
read them just after. Every matmul runs in full f32 (TF32 off for matmul and cuDNN),
so the plain versions are exact oracles.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
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
# the plain versions' [B, S, C] distances and their sort come and go in
# blocks of 10-20 GB beside the stores; growable segments keep the freed
# blocks from fragmenting the card's memory
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
            "bfloat16": 989e12,         # dense bf16 tensor-core rate
            "int8": 1979e12}            # dense INT8 tensor-core rate


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


def compare_rerank(what, q_pad, qbuf, vecs, ids, shortlist, k, *, exact_ids=False):
    """Kernel vs plain version on the occupied slots, under ``l2_atol``: the
    two sum the expansion in other orders. Returns (max abs err, occupied
    slots whose ids equal element for element)."""
    import torch

    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops

    args = (q_pad, qbuf, vecs, ids, shortlist, k)
    d_k, i_k = kops.rerank_topk_qbuf(*args, impl="cuda")
    d_p, i_p = kops.rerank_topk_qbuf(*args, impl="ref")
    occ = rt.occupied(q_pad, qbuf)
    if not (bool(torch.isinf(d_k[~occ]).all()) and bool((i_k[~occ] == -1).all())):
        raise AssertionError(f"{what}: empty slots not flushed as inf / -1")
    err = rt.assert_topk_match(d_k[occ], i_k[occ], d_p[occ], i_p[occ],
                               rt.qbuf_atol(q_pad, qbuf, vecs.float(), ids),
                               exact_ids=exact_ids, what=what)
    return err, int((i_k[occ] == i_p[occ]).all(-1).sum())


def compare_dedup(what, dists, ids, k) -> float:
    """Kernel vs plain version: no arithmetic, so the answers and the
    duplicate counts equal element for element."""
    import torch

    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops

    dups_k, dups_p = (torch.empty(dists.shape[0], dtype=torch.int64, device=dists.device)
                      for _ in range(2))
    d_k, i_k = kops.dedup_topk(dists, ids, k, impl="cuda", dups=dups_k)
    d_p, i_p = kops.dedup_topk(dists, ids, k, impl="ref", dups=dups_p)
    if not torch.equal(dups_k, dups_p):
        raise AssertionError(f"{what}: duplicate counts differ")
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
    paths' widths (d = 128, k = 100; merge rows of 6,400 entries; ADC with
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
    for case in rt.RERANK_CASES:
        (q_pad, qbuf, vecs, ids, sl), k, dtype, exact = rt.rerank_case(case, width="main")
        q_pad, qbuf, vecs, ids, sl = (torch.from_numpy(a).to(dev)
                                      for a in (q_pad, qbuf, vecs, ids, sl))
        err, _ = compare_rerank(case, q_pad, qbuf, vecs.to(getattr(torch, dtype)), ids, sl, k,
                                exact_ids=exact)
        log(f"edges  rerank_topk_qbuf  {case}: ok{', ids equal' if exact else ''} (d "
            f"{vecs.shape[2]}, {dtype}, rk {sl.shape[2]}, k {k}; max abs err {err:.3g})")
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


def rerank_bound(q_pad, qbuf, vecs, ids, shortlist, k):
    """Least time for the exact rerank, the work counted as the benchmark's
    reader ``rerank_topk_qbuf_roofline`` counts it."""
    import importlib.util

    path = os.path.join(ROOT, "lirabench", "layers", "rerank_topk_qbuf_roofline.py")
    spec = importlib.util.spec_from_file_location("rerank_topk_qbuf_roofline", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    nbytes, ops = reader.work(**reader.hook({}, q_pad, qbuf, vecs, ids, shortlist, k))
    return float(nbytes), float(ops), PEAK_OPS["float32"]


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
                              ("l2_topk_qbuf", "pq_adc_topk_qbuf", "rerank_topk_qbuf",
                               "dedup_topk"))
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


# ---------------------------------------------------------------- the byte tier

U8_CONFIG = "lirabench/configs/bigann-u8.json"   # the deployment the benchmark's cell runs
U8_BATCH = 8_192                                 # one call of its batch8k traffic


def u8_bound(q_pad, qbuf, cands, cand_ids, k):
    """Least time for this run's byte scan: each input read once (the query
    plane, qbuf, and of every partition with an occupied slot its valid
    rows at d bytes, their int32 ||x||² and ids), each output written once;
    2·d integer operations per (occupied slot, valid candidate), at the
    INT8 tensor-core rate."""
    from repro_torch import testing as rt

    occ = rt.occupied(q_pad, qbuf).sum(1).double()
    valid = (cand_ids >= 0).sum(1).double()
    d = cands.shape[2]
    nbytes = (q_pad.numel() + qbuf.numel() * 4 + float((valid[occ > 0] * (d + 8)).sum())
              + qbuf.numel() * k * 8)
    return nbytes, float((occ * valid).sum()) * 2 * d, PEAK_OPS["int8"]


def u8_phase(smi, dev="cuda") -> dict:
    """Phase 26: the u8 tier at bigann-u8's deployment (the configuration
    file the benchmark's cell runs: 4,000,000 uint8 rows at d 128, B 1,024,
    k 100), built on the card. One batch of 8,192 uint8 queries through
    search() with the launch counters zeroed just before: one launch of
    l2u8_topk_qbuf and of dedup_topk, none of the f32 scan; every returned
    distance equal to the integer Σ(q − x)² of its row, and recall@100
    (a row at the exact 100th distance or nearer counts) at least the
    configuration's limit. The byte scan on the operands the batch gave it:
    equal bit for bit to its plain version (int64 arithmetic) on every
    occupied slot, inf / -1 on the others, and to the f32 scan over the rows
    cast to f32; timed beside its bound, with every slot empty, and its
    registers. Returns its entry of the kernels JSON."""
    import numpy as np
    import torch

    from lirabench import data as bench_data
    from repro_torch.core import ground_truth as gt
    from repro_torch.kernels import dedup_topk as dd_mod, l2_topk as l2_mod
    from repro_torch.kernels import l2u8_topk as u8_mod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.serving.api import BuildConfig
    from repro_torch.serving.engine import LiraEngine

    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, U8_CONFIG)) as f:
        config = json.load(f)
    n = int(config["n_points"])
    base, queries = bench_data.make_vectors(config["data"], n, U8_BATCH, dev)
    t0 = time.perf_counter()
    eng = LiraEngine.build(base, BuildConfig(**config["build"]), device=dev)
    torch.cuda.synchronize()
    log(f"u8     build over {n} uint8 rows {time.perf_counter() - t0:.1f} s | capacity "
        f"{eng.cfg.capacity} | store " + ", ".join(
            f"{name} {t.numel() * t.element_size() / 2**30:.3f} GiB {t.dtype}"
            for name, t in eng.store.items()) + f" | {eng.cfg}")
    q_np = queries.cpu().numpy()
    captured = {}
    inner = kops.l2u8_topk_qbuf

    def capture(*args, **kw):
        captured.setdefault("args", args)
        return inner(*args, **kw)

    counters = {"l2u8_topk_qbuf": u8_mod, "l2_topk_qbuf": l2_mod, "dedup_topk": dd_mod}
    eng.search(q_np)             # the batch's serve step built before the counted call
    kops.l2u8_topk_qbuf = capture
    try:
        for mod in counters.values():
            mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.search(q_np)
        call_ms = 1e3 * (time.perf_counter() - t0)
        launches = {name: mod.launches for name, mod in counters.items()}
    finally:
        kops.l2u8_topk_qbuf = inner
    if launches != {"l2u8_topk_qbuf": 1, "l2_topk_qbuf": 0, "dedup_topk": 1}:
        raise AssertionError(f"u8 batch: launches {launches}")
    if res.stats.tier != "u8":
        raise AssertionError(f"u8 batch served by tier {res.stats.tier}")
    log(f"u8     one batch of {len(q_np)} uint8 queries in {call_ms:.1f} ms (tier "
        f"{res.stats.tier}, impl {res.stats.impl}, mean nprobe_eff "
        f"{float(res.nprobe_eff.mean()):.3f}, overflow {res.overflow}); launches {launches}")
    # every returned distance is its row's integer sum of squares
    ids = torch.as_tensor(res.ids, device=dev).long()
    got = torch.as_tensor(res.dists, device=dev)
    if not bool((ids >= 0).all()):
        raise AssertionError("u8 batch: a row has fewer than k answers")
    exact = torch.cat([((queries[s:s + 256, None, :].int() - base[ids[s:s + 256]].int()) ** 2)
                       .sum(-1) for s in range(0, len(q_np), 256)])
    if not torch.equal(got, exact.float()):
        bad = int((got != exact.float()).sum())
        raise AssertionError(f"u8 batch: {bad} returned distances differ from Σ(q − x)²")
    # recall against the exact k-th distance (f32 with TF32 off is exact on bytes at d 128)
    kth, _ = gt.exact_knn(queries, base, eng.cfg.k, batch=256, device=torch.device(dev))
    recall = float((res.dists <= kth[:, -1:]).mean())
    floor = float(config["checks"]["recall"])
    log(f"u8     every returned distance equals the integer sum of squares; recall@100 "
        f"{recall:.4f} against the exact 100th distance (the configuration's limit {floor})")
    if recall < floor:
        raise AssertionError(f"u8 recall@100 {recall:.4f} < {floor}")
    del res, ids, got, exact, kth
    # the kernel on the batch's operands
    q_pad, qbuf, cands, sqn, cid, k = captured.pop("args")
    occ = qbuf < q_pad.shape[0] - 1
    kd, ki = u8_mod.l2u8_topk_qbuf(q_pad, qbuf, cands, sqn, cid, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pd, pi = kref.l2u8_topk_qbuf_ref(q_pad, qbuf, cands, sqn, cid, k)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not (torch.equal(kd[occ], pd[occ]) and torch.equal(ki[occ], pi[occ])
            and bool(torch.isinf(kd[~occ]).all()) and bool((ki[~occ] == -1).all())):
        raise AssertionError("l2u8_topk_qbuf at the u8 batch's operands differs from its "
                             "plain version")
    del pd, pi
    ms = time_ms(lambda: u8_mod.l2u8_topk_qbuf(q_pad, qbuf, cands, sqn, cid, k), 20)
    bound = bound_entry(*u8_bound(q_pad, qbuf, cands, cid, k))
    qb_empty = torch.full_like(qbuf, q_pad.shape[0] - 1)
    ms_empty = time_ms(lambda: u8_mod.l2u8_topk_qbuf(q_pad, qb_empty, cands, sqn, cid, k), 10)
    del qb_empty
    pairs = float((occ.sum(1).double() * (cid >= 0).sum(1).double()).sum())
    regs = ptxas_report("l2u8_topk_qbuf", "l2u8_topk_qbuf_kernel")
    log(f"kernel l2u8_topk_qbuf at the u8 batch's operands (B {qbuf.shape[0]}, S "
        f"{qbuf.shape[1]}, C {cands.shape[1]}, d {cands.shape[2]}, k {k}, {int(occ.sum())} "
        f"occupied slots, {pairs:.4g} pairs): equal bit for bit to its plain version; "
        f"{ms:.3f} ms (plain {plain_ms:.1f} ms, bound {bound[0]:.3f} ms by {bound[1]}); every "
        f"slot empty {ms_empty:.3f} ms; {regs}")
    # the f32 scan over the same rows cast: an independent kernel, the same bits
    qf, cf = q_pad.float(), cands.float()
    f32_ms = time_ms(lambda: l2_mod.l2_topk_qbuf(qf, qbuf, cf, cid, k), 5)
    fd, fi = l2_mod.l2_topk_qbuf(qf, qbuf, cf, cid, k)
    if not (torch.equal(fd[occ], kd[occ]) and torch.equal(fi[occ], ki[occ])):
        raise AssertionError("l2u8_topk_qbuf differs from the f32 scan over the rows cast")
    log(f"kernel l2_topk_qbuf over the same rows cast to f32: equal bit for bit, {f32_ms:.3f} ms")
    del qf, cf, fd, fi, kd, ki
    entry = kernel_entry(
        "l2u8_topk_qbuf", "l2u8_topk_qbuf.cu", None, launches["l2u8_topk_qbuf"], 0.0, ms,
        plain_ms, bound,
        {"q_pad": list(q_pad.shape), "qbuf": list(qbuf.shape), "cands": list(cands.shape),
         "k": k, "occupied_slots": int(occ.sum()), "pairs": pairs, "all_empty_ms": ms_empty,
         "registers": regs, "f32_scan_ms": f32_ms, "recall_at_100": recall,
         "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    del q_pad, qbuf, cands, sqn, cid, captured, eng, base, queries
    torch.cuda.empty_cache()
    log(f"u8     phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return entry


RERANK_CONFIG = "lirabench/configs/lira-ann-q.json"   # the deployment the cell runs
RERANK_BATCH = 8_192                                 # one call of its batch8k traffic


def rerank_phase(smi, dev="cuda") -> dict:
    """Phase 27: the quantized tiers' exact rerank at lira-ann-q's
    deployment (the configuration file the benchmark's cell runs), built on
    the card. One batch of 8,192 queries through search() with the launch
    counters zeroed just before: the ADC scan, the rerank and dedup_topk once
    each, the f32 scan not at all. The rerank on the operands the batch gave
    it: held against its plain version under the comparison rule (the rows
    whose ids equal element for element counted), inf / -1 on the empty
    slots, two runs equal bit for bit; timed beside its bound and the plain
    version, and with every slot empty. Returns its entry of the kernels
    JSON."""
    import torch

    from lirabench import data as bench_data
    from repro_torch import testing as rt
    from repro_torch.kernels import dedup_topk as dd_mod, l2_topk as l2_mod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pq_adc as adc_mod
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rerank_topk as rr_mod
    from repro_torch.serving.api import BuildConfig
    from repro_torch.serving.engine import LiraEngine

    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, RERANK_CONFIG)) as f:
        config = json.load(f)
    n = int(config["n_points"])
    base, queries = bench_data.make_vectors(config["data"], n, RERANK_BATCH, dev)
    t0 = time.perf_counter()
    eng = LiraEngine.build(base, BuildConfig(**config["build"]), device=dev)
    torch.cuda.synchronize()
    log(f"rerank build over {n} rows {time.perf_counter() - t0:.1f} s | capacity "
        f"{eng.cfg.capacity} | {eng.cfg}")
    del base
    q_np = queries.cpu().numpy()
    captured = {}
    inner = kops.rerank_topk_qbuf

    def capture(*args, **kw):
        captured.setdefault("args", args)
        return inner(*args, **kw)

    counters = {"pq_adc_topk_qbuf": adc_mod, "rerank_topk_qbuf": rr_mod,
                "dedup_topk": dd_mod, "l2_topk_qbuf": l2_mod}
    eng.search(q_np)             # the batch's serve step built before the counted call
    kops.rerank_topk_qbuf = capture
    try:
        for mod in counters.values():
            mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.search(q_np)
        call_ms = 1e3 * (time.perf_counter() - t0)
        launches = {name: mod.launches for name, mod in counters.items()}
    finally:
        kops.rerank_topk_qbuf = inner
    want = {"pq_adc_topk_qbuf": 1, "rerank_topk_qbuf": 1, "dedup_topk": 1, "l2_topk_qbuf": 0}
    if launches != want or res.stats.tier != "residual_pq":
        raise AssertionError(f"rerank batch: launches {launches}, tier {res.stats.tier}")
    log(f"rerank one batch of {len(q_np)} queries in {call_ms:.1f} ms (tier {res.stats.tier}, "
        f"impl {res.stats.impl}, mean nprobe_eff {float(res.nprobe_eff.mean()):.3f}, overflow "
        f"{res.overflow}); launches {launches}")
    del res, eng
    torch.cuda.empty_cache()
    q_pad, qbuf, vecs, ids, sl, k = captured.pop("args")
    kd, ki = rr_mod.rerank_topk_qbuf(q_pad, qbuf, vecs, ids, sl, k)
    again = rr_mod.rerank_topk_qbuf(q_pad, qbuf, vecs, ids, sl, k)
    if not (torch.equal(kd.view(torch.int32), again[0].view(torch.int32))
            and torch.equal(ki, again[1])):
        raise AssertionError("rerank_topk_qbuf: two runs differ")
    del kd, ki, again
    err, rows_equal = compare_rerank("rerank_topk_qbuf at the batch's operands", q_pad, qbuf,
                                     vecs, ids, sl, k)
    ms = time_ms(lambda: rr_mod.rerank_topk_qbuf(q_pad, qbuf, vecs, ids, sl, k), 20)
    plain_ms = time_ms(lambda: kref.rerank_topk_qbuf_ref(q_pad, qbuf, vecs, ids, sl, k), 2, 1)
    bound = bound_entry(*rerank_bound(q_pad, qbuf, vecs, ids, sl, k))
    qb_empty = torch.full_like(qbuf, q_pad.shape[0] - 1)
    ms_empty = time_ms(lambda: rr_mod.rerank_topk_qbuf(q_pad, qb_empty, vecs, ids, sl, k), 10)
    del qb_empty
    regs = ptxas_report("rerank_topk_qbuf", "rerank_topk_qbuf_kernelIfLi4")
    n_occ = int(rt.occupied(q_pad, qbuf).sum())
    log(f"kernel rerank_topk_qbuf at the batch's operands (B {qbuf.shape[0]}, S "
        f"{qbuf.shape[1]}, C {vecs.shape[1]}, d {vecs.shape[2]}, rk {sl.shape[2]}, k {k}, "
        f"{n_occ} occupied slots): within l2_atol of its plain version (max abs err "
        f"{err:.3g}), {rows_equal} of {n_occ} rows' ids equal element for element, two runs "
        f"equal bit for bit; {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {bound[0]:.3f} ms by "
        f"{bound[1]}); every slot empty {ms_empty:.3f} ms; {regs}")
    entry = kernel_entry(
        "rerank_topk_qbuf", "rerank_topk_qbuf.cu", None, launches["rerank_topk_qbuf"], err, ms,
        plain_ms, bound,
        {"q_pad": list(q_pad.shape), "qbuf": list(qbuf.shape), "vecs": list(vecs.shape),
         "rk": sl.shape[2], "k": k, "occupied_slots": n_occ, "rows_ids_equal": rows_equal,
         "all_empty_ms": ms_empty, "registers": regs,
         "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    del q_pad, qbuf, vecs, ids, sl, captured, queries
    torch.cuda.empty_cache()
    log(f"rerank phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return entry


# ---------------------------------------------------------------- mesh and cluster

SERVE_KERNELS = ("l2_topk_qbuf", "dedup_topk", "pq_adc_topk_qbuf", "rerank_topk_qbuf")


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
    from repro_torch.kernels import rerank_topk as rr_mod

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
            kernel = lambda: dd_mod.dedup_topk(*args, **kw)  # noqa: E731
            bound = (pd.numel() * 8 + pd.shape[0] * k * 8, 0.0, PEAK_OPS["float32"])
        elif name == "rerank_topk_qbuf":
            err, _ = compare_rerank(f"{what} rerank_topk_qbuf {shape}", *args)
            kernel, bound = (lambda: rr_mod.rerank_topk_qbuf(*args)), rerank_bound(*args)
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
    with each rank's kernels launched and the four serve kernels held against
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
            rerank = model_n * n_b if tier == "residual_pq" else 0
            if (launches[scan] != model_n * n_b or launches["dedup_topk"] != (model_n + 1) * n_b
                    or launches["rerank_topk_qbuf"] != rerank):
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
        rerank = 4 * len(res) if tier == "residual_pq" else 0
        if (launches[scan] != 4 * len(res) or launches["dedup_topk"] != 4 * len(res)
                or launches["rerank_topk_qbuf"] != rerank):
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


def run_module(module, *args, tag: str, expect_fail: bool = False) -> str:
    """``python -m <module> <args>`` on the card, its output lines logged
    under ``tag``; fails unless it exits 0 (or, with ``expect_fail``, does
    not). Returns its standard output and error."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    for line in out.stdout.splitlines():
        log(f"{tag} | {line}")
    if bool(out.returncode) != expect_fail:
        raise AssertionError(f"{tag} exited {out.returncode}: {out.stderr[-2000:]}")
    log(f"{tag}: exit {out.returncode} in {time.perf_counter() - t0:.1f} s")
    return out.stdout + out.stderr


def run_example(name, *args) -> str:
    """``python -m repro_torch.examples.<name>`` on the card; its output."""
    return run_module(f"repro_torch.examples.{name}", *args, tag=f"examples {name}")


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


def recut_cache(cache, src, dst, b: int, s: int, n_len: int) -> dict:
    """A cache of ``s`` positions held as ``src``'s ranks' slices, as the
    slices of an ``n_len``-position cache over ``dst`` (zeros past ``s``):
    each of ``dst``'s slices copies what it shares with each of ``src``'s."""
    from repro_torch.models import transformer as ttr

    have = ttr.cache_layout(src, b, s)
    out = {}
    for name, parts in cache.items():
        p0 = parts[0]
        out[name] = []
        for ((b0, b1), (s0, s1)), dev in zip(ttr.cache_layout(dst, b, n_len), dst.devices):
            t = p0.new_zeros((p0.shape[0], b1 - b0, s1 - s0, *p0.shape[3:]), device=dev)
            for ((c0, c1), (q0, q1)), part in zip(have, parts):
                lb, hb, ls, hs = max(b0, c0), min(b1, c1), max(s0, q0), min(s1, q1)
                if lb < hb and ls < hs:
                    t[:, lb - b0:hb - b0, ls - s0:hs - s0] = \
                        part[:, lb - c0:hb - c0, ls - q0:hs - q0].to(dev)
            out[name].append(t)
    return out


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
    one = make_test_mesh(1, 1, device=dev)
    bundle = build_bundle(cfg, one)
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
        dcache = recut_cache(cache, one, one, b, s, cache_len)
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
    sides = {}
    for side, model, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        mesh = make_test_mesh(1, 1, device=d)
        logits, cache = ttr.make_prefill_step(cfg, mesh)(model, toks.to(d))
        full = recut_cache(cache, mesh, mesh, b, s, s + steps)
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


# ---------------------------------------------------------------- LM training

LM_TRAIN_SEQ = 4096                   # train_4k's sequence length, uncut
# train_4k's global batch of 256 cut to the largest that fits (a): on an
# NVIDIA H100 80GB HBM3 at 700.00 W, 8 takes 56.8 GiB (26.4 of them the
# parameters and f32 moments), so 16 would need ~87
LM_TRAIN_BATCH = 8
# (a), (a'), (b): the first step untimed where there are more; (a') takes
# one step of twice (a)'s, its peak the point
LM_TRAIN_STEPS, LM_ACCUM_STEPS, LM_MOE_TRAIN_STEPS = 3, 1, 4
LM_MOE_TRAIN_BATCH = 2                # (b): its unchunked logits would be 5.4 GB
LM_TRAIN_GATE = (2, 256)              # (c), (d): 2 layers at each width, [2, 256]
LM_TRAIN_ATOL = 1e-4                  # (c): card against CPU in f32, and the variants
LM_GATE_TX = dict(lr=1e-2, weight_decay=0.1, eps=1e-3)   # tests/test_torch_lm_train.py's
LM_RESUME_STEPS, LM_RESUME_EVERY, LM_RESUME_FAIL = 4, 2, 3      # (d)
LM_LAUNCH_STEPS, LM_LAUNCH_FAIL = 60, 55                        # (e): a checkpoint every 50
LM_METRICS = ("loss", "ce", "moe_aux", "grad_norm")


def lm_train_bound(cfg, b: int, s: int) -> dict:
    """A step's operations: 8·N·T for a full-remat step (N the parameters a
    token uses: forward, the layer's recompute and a backward of twice the
    forward), plus the block scan's attention (every KV block: 4·b·H·s²·Dh a
    layer's forward) once for the forward, once for the recompute and twice
    for backward, all at the dense bf16 peak. Beside it the reference's
    arithmetic: the attention's products run in f32 on the CUDA cores (TF32
    off), and the scan recomputes each block once more in backward (five
    passes), at 67 TFLOP/s."""
    t = b * s
    matmul = 8 * cfg.active_param_count * t
    attn = 4 * b * cfg.n_heads * s * s * cfg.head_dim * cfg.n_layers
    bound = (matmul + 4 * attn) / PEAK_OPS["bfloat16"]
    f32 = matmul / PEAK_OPS["bfloat16"] + 5 * attn / PEAK_OPS["float32"]
    return dict(bound_ms=1e3 * bound, tflop=(matmul + 4 * attn) / 1e12,
                f32_attention_bound_ms=1e3 * f32)


def lm_train_run(what, cfg, state, batch: int, steps: int, dev, count_routing=False) -> dict:
    """``steps`` train steps of [batch, LM_TRAIN_SEQ] TokenPipeline batches
    through the Trainer and build_bundle(cfg).step(train shape), each timed
    on the host clock between synchronizes; the first is the warm-up (and,
    with ``count_routing``, counts the MoE dispatch's capacity and kept
    pairs a layer). Every metric must be finite."""
    import math

    import numpy as np
    import torch

    from repro_torch.data.pipeline import PipelineSpec, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.api import ShapeSpec
    from repro_torch.train.trainer import Trainer

    shape = ShapeSpec("train_4k", "train", {"seq_len": LM_TRAIN_SEQ, "global_batch": batch})
    fn = build_bundle(cfg, make_test_mesh(1, 1, device=dev)).step(shape).fn
    secs, routing = [], []
    dispatch = lm_layers.moe_dispatch_local

    def counted(x_all, router_w, e0, e_loc, top_k, capacity):
        out = dispatch(x_all, router_w, e0, e_loc, top_k, capacity)
        routing.append((x_all.shape[0], capacity, int((out[2] < x_all.shape[0]).sum())))
        return out

    def timed(st, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if count_routing and not secs:
            lm_layers.moe_dispatch_local = counted
        try:
            out = fn(st, b)
        finally:
            lm_layers.moe_dispatch_local = dispatch
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return out

    pipe = TokenPipeline(PipelineSpec(global_batch=batch), LM_TRAIN_SEQ, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    _, hist = Trainer(timed, state, pipe, log_every=1).run(steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(hist) != steps or not all(math.isfinite(h[k]) for h in hist for k in LM_METRICS):
        raise AssertionError(f"{what}: metrics {hist}")
    step = float(np.median(secs[1:] or secs))
    out = dict(batch=batch, steps=steps, step_ms=1e3 * step, warmup_ms=1e3 * secs[0],
               tok_s=batch * LM_TRAIN_SEQ / step, peak_gib=peak, **lm_train_bound(
                   cfg, batch, LM_TRAIN_SEQ),
               losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist])
    if count_routing:
        first = routing[:cfg.n_layers]          # the forward's; the recompute repeats them
        out.update(capacity=first[0][1], tokens=first[0][0],
                   dropped=sum(t * cfg.moe.top_k - kept for t, _, kept in first),
                   pairs=sum(t * cfg.moe.top_k for t, _, _ in first))
    return out


def lm_train_report(what, cfg, res, smi) -> None:
    log(f"{what} {cfg.arch}: {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, remat {cfg.remat}, grad_accum {cfg.grad_accum}, logits_chunk "
        f"{cfg.logits_chunk}: [{res['batch']}, {LM_TRAIN_SEQ}] "
        + (f"median {res['step_ms']:.1f} ms a step of {res['steps'] - 1} after a warm-up of "
           f"{res['warmup_ms']:.1f}" if res["steps"] > 1 else
           f"{res['step_ms']:.1f} ms for its one step (warm-up included)")
        + f", {res['tok_s']:.0f} tokens/s; bound "
        f"{res['bound_ms']:.1f} ms by operations ({res['tflop']:.1f} TFLOP at "
        f"{PEAK_OPS['bfloat16'] / 1e12:.0f} TFLOP/s), {res['f32_attention_bound_ms']:.1f} ms with "
        f"the scan's f32 attention at {PEAK_OPS['float32'] / 1e12:.0f}; peak "
        f"{res['peak_gib']:.2f} GiB; {smi}")
    log(f"{what} loss by step {[round(v, 4) for v in res['losses']]}, grad_norm "
        f"{[round(v, 4) for v in res['grad_norms']]}")
    if "capacity" in res:
        log(f"{what} MoE: {res['tokens']} tokens a layer, capacity {res['capacity']}, dropped "
            f"{res['dropped']} of {res['pairs']} (token, expert) pairs over {cfg.n_layers} layers")


def lm_train_breakdown(what, cfg, state, batch: int, step_ms: float, smi) -> dict:
    """Where (a)'s step goes, each part timed alone on the host clock
    between synchronizes at the step's shapes: one layer's block scan
    forward under autograd (f) and forward + backward (fb: the backward
    recomputes each KV block), so the step's scans take L·(f + fb) (the
    layer's recompute is one more forward); the loss (unembed, f32
    logsumexp) forward + backward; AdamW's update of every parameter. The
    rest is the layers' bf16 matmuls, norms, RoPE, SwiGLU, the embedding,
    the clip and the host."""
    import torch

    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as ttr

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    s, dt, dev = LM_TRAIN_SEQ, getattr(torch, cfg.dtype), state.device
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((batch, s, h, cfg.head_dim), generator=g, device=dev).to(dt)
               .requires_grad_() for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    block = min(cfg.attn_block, s)

    def scan():
        return lm_layers.flash_attention(q, k, v, causal=True, block=block)

    f_ms = timed(scan)
    fb_ms = timed(lambda: torch.autograd.grad(scan().float().sum(), (q, k, v)))
    del q, k, v
    h = torch.randn((batch, s, cfg.d_model), generator=g, device=dev).to(dt).requires_grad_()
    labels = torch.randint(0, cfg.vocab, (batch, s), generator=g, device=dev)
    model, tx = state
    ce_ms = timed(lambda: torch.autograd.grad(
        ttr._softmax_ce(h, model.unembed, labels, cfg.logits_chunk), (h, model.unembed)))
    del h, labels
    grads = [torch.zeros_like(p) for p in tx.params]
    opt_ms = timed(lambda: tx.update(grads))
    del grads
    attn_ms = cfg.n_layers * (f_ms + fb_ms)
    rest = step_ms - attn_ms - ce_ms - opt_ms
    log(f"{what} where a step of {step_ms:.0f} ms goes: the block scans {attn_ms:.0f} ms "
        f"({cfg.n_layers} layers x (forward {f_ms:.1f} + forward and backward {fb_ms:.1f})), "
        f"the loss {ce_ms:.1f} ms (forward and backward), AdamW's update {opt_ms:.1f} ms "
        f"({len(tx.params)} tensors), the rest {rest:.0f} ms; {smi}")
    return dict(scan_forward_ms=f_ms, scan_fb_ms=fb_ms, scans_ms=attn_ms, loss_ms=ce_ms,
                adamw_ms=opt_ms, rest_ms=rest)


def lm_train_step_once(model, cfg, batch, dev):
    """One train step of ``model`` under LM_GATE_TX's AdamW: the metrics
    (a CPU tensor, LM_METRICS' order) and the model (updated in place)."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as ttr

    state = ttr.TrainState(model, ttr.adamw(model, **LM_GATE_TX))
    step = ttr.make_train_step(cfg, make_test_mesh(1, 1, device=dev))
    _, m = step(state, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    return torch.stack([m[k] for k in LM_METRICS]).cpu()


def lm_params_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def lm_param_err(a, b) -> float:
    """Largest |difference| between two LMs' parameters, on ``a``'s device."""
    return max(float((x.detach() - y.detach().to(x.device)).abs().max())
               for x, y in zip(a.parameters(), b.parameters()))


def lm_train_gate(what, cfg, dev, *, accum: bool) -> dict:
    """(c) At 2 layers in f32 from one set of parameters: one train step on
    the card and on the CPU (metrics and updated parameters within
    LM_TRAIN_ATOL); on the card remat none and dots equal to full bit for
    bit, logits_chunk 8 within LM_TRAIN_ATOL of 0 and, with ``accum``,
    grad_accum 4 within LM_TRAIN_ATOL of 1 on one [4, s] batch."""
    import copy

    import torch

    from repro_torch.data.pipeline import PipelineSpec, TokenPipeline
    from repro_torch.models import transformer as ttr

    t0 = time.perf_counter()
    b, s = LM_TRAIN_GATE
    batch = TokenPipeline(PipelineSpec(global_batch=2 * b), s, cfg.vocab).batch_at(0)
    two = {k: v[:b] for k, v in batch.items()}
    init = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    card = copy.deepcopy(init)
    m_card = lm_train_step_once(card, cfg, two, dev)
    cpu = copy.deepcopy(init).to("cpu")
    m_cpu = lm_train_step_once(cpu, cfg, two, "cpu")
    err_m, err_p = float((m_card - m_cpu).abs().max()), lm_param_err(card, cpu)
    del cpu
    if not err_m <= LM_TRAIN_ATOL or not err_p <= LM_TRAIN_ATOL:
        raise AssertionError(f"{what}: card != CPU: metrics {m_card.tolist()} vs "
                             f"{m_cpu.tolist()}, parameters by {err_p}")
    out = dict(metrics_err=err_m, params_err=err_p)
    for remat in ("none", "dots"):
        model = copy.deepcopy(init)
        m = lm_train_step_once(model, dataclasses.replace(cfg, remat=remat), two, dev)
        if not torch.equal(m, m_card) or not lm_params_equal(model, card):
            raise AssertionError(f"{what}: remat {remat} differs from full")
        del model
    variants = [("logits_chunk 8", dataclasses.replace(cfg, logits_chunk=8), two, m_card, card)]
    if accum:
        base = copy.deepcopy(init)
        m_base = lm_train_step_once(base, cfg, batch, dev)
        variants.append(("grad_accum 4", dataclasses.replace(cfg, grad_accum=4), batch, m_base,
                         base))
    for name, vcfg, vbatch, m_ref, ref in variants:
        model = copy.deepcopy(init)
        m = lm_train_step_once(model, vcfg, vbatch, dev)
        errs = (float((m - m_ref).abs().max()), lm_param_err(model, ref))
        if not max(errs) <= LM_TRAIN_ATOL:
            raise AssertionError(f"{what}: {name}: metrics {m.tolist()} vs {m_ref.tolist()}, "
                                 f"parameters by {errs[1]}")
        out[name] = errs
        del model
    log(f"{what}: {cfg.n_layers} layers at d {cfg.d_model}, vocab {cfg.vocab}, f32, [{b}, {s}]: "
        f"card = CPU (metrics within {err_m:.3g}, updated parameters within {err_p:.3g}; "
        f"tolerance {LM_TRAIN_ATOL}); remat none = full = dots bit for bit; "
        + "; ".join(f"{n} against its base: metrics {out[n][0]:.3g}, parameters {out[n][1]:.3g}"
                    for n, *_ in variants)
        + f" ({time.perf_counter() - t0:.1f} s)")
    return out


def lm_train_determinism(what, cfg, dev, *, resume: bool) -> None:
    """(d) bf16 at 2 layers: one train step run twice from one state gives
    the same metrics and parameters bit for bit; with ``resume``, a Trainer
    failed after step LM_RESUME_FAIL's update resumes from its checkpoint and
    ends equal bit for bit to an uninterrupted run."""
    import copy
    import shutil

    import torch

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import PipelineSpec, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as ttr
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    b, s = LM_TRAIN_GATE
    pipe = TokenPipeline(PipelineSpec(global_batch=b, seed=1), s, cfg.vocab)
    init = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(2), dev)
    runs = []
    for _ in range(2):
        model = copy.deepcopy(init)
        runs.append((lm_train_step_once(model, cfg, pipe.batch_at(0), dev), model))
    if not torch.equal(runs[0][0], runs[1][0]) or not lm_params_equal(runs[0][1], runs[1][1]):
        raise AssertionError(f"{what}: two runs of one step differ: {runs[0][0].tolist()} vs "
                             f"{runs[1][0].tolist()}")
    del runs
    msg = (f"{what}: {cfg.arch} width, {cfg.n_layers} layers, bf16: a step run twice equal bit "
           f"for bit")
    if resume:
        ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_lm_ckpt")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        step = ttr.make_train_step(cfg, make_test_mesh(1, 1, device=dev))

        def trainer(ckpt=None):
            model = copy.deepcopy(init)
            return Trainer(step, ttr.TrainState(model, ttr.adamw(model, **LM_GATE_TX)), pipe,
                           ckpt_manager=ckpt, ckpt_every=LM_RESUME_EVERY, log_every=1)

        gold, hist = trainer().run(LM_RESUME_STEPS)
        cm = CheckpointManager(ckpt_dir, keep=2)
        try:
            trainer(cm).run(LM_RESUME_STEPS, fail_at=LM_RESUME_FAIL)
            raise AssertionError(f"{what}: the run did not fail")
        except RuntimeError as e:
            if "simulated failure" not in str(e):
                raise
        again = trainer(cm)
        resumed = again.start_step
        if resumed != LM_RESUME_FAIL // LM_RESUME_EVERY * LM_RESUME_EVERY:
            raise AssertionError(f"{what}: resumed at step {resumed}")
        state, hist2 = again.run(LM_RESUME_STEPS)
        bad = [n for n, x, y in zip(gold.leaf_names(), gold.leaves(), state.leaves())
               if not torch.equal(x, y)]
        if bad or [h["loss"] for h in hist] != [h["loss"] for h in hist2]:
            raise AssertionError(f"{what}: the resumed run differs in {bad}")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        msg += (f"; failed after step {LM_RESUME_FAIL}'s update, resumed at step "
                f"{resumed}: all {len(gold.leaf_names())} state leaves and "
                f"the losses equal bit for bit to an uninterrupted run of {LM_RESUME_STEPS}")
    log(msg + f" ({time.perf_counter() - t0:.1f} s)")


def launcher_restart(arch: str, tag: str) -> tuple:
    """python -m repro_torch.launch.train at ``arch``'s SMOKE config, failed
    at step LM_LAUNCH_FAIL (after the step-50 checkpoint), restarted to
    LM_LAUNCH_STEPS, and run again uninterrupted: the two last checkpoints
    must be equal file for file. Returns (their step, their leaf count)."""
    import shutil

    from repro_torch.ckpt.checkpoint import load_leaves, read_manifest

    dirs = [os.path.join(ROOT, "build", f"chip_smoke_launch_{n}") for n in ("a", "b")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    args = ["--arch", arch, "--steps", str(LM_LAUNCH_STEPS)]
    text = run_module("repro_torch.launch.train", *args, "--ckpt-dir", dirs[0], "--fail-at",
                      str(LM_LAUNCH_FAIL), tag=tag, expect_fail=True)
    if f"simulated failure at step {LM_LAUNCH_FAIL}" not in text:
        raise AssertionError(f"{tag} the launcher did not fail as asked")
    text = run_module("repro_torch.launch.train", *args, "--ckpt-dir", dirs[0], tag=tag)
    if "starting at step 50" not in text:
        raise AssertionError(f"{tag} the restart did not resume at step 50")
    run_module("repro_torch.launch.train", *args, "--ckpt-dir", dirs[1], tag=tag)
    files = []
    for d in dirs:
        step_dir, meta = read_manifest(d)
        files.append((meta["step"], load_leaves(step_dir, meta)))
    (sa, la), (sb, lb) = files
    if sa != sb or len(la) != len(lb) or any(x.tobytes() != y.tobytes() for x, y in zip(la, lb)):
        raise AssertionError(f"{tag} the restarted run's last checkpoint differs from the "
                             "uninterrupted run's")
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    return sa, len(la)


def lm_launch_phase() -> None:
    """(e) The launcher at stablelm-3b's SMOKE config, failed and restarted
    (``launcher_restart``); lm_pretrain at its own 200 steps, whose loss
    falls."""
    import shutil

    sa, n_leaves = launcher_restart("stablelm-3b", "lmtrain train")
    pre = os.path.join(ROOT, "build", "chip_smoke_lm_pretrain")
    shutil.rmtree(pre, ignore_errors=True)
    text = run_module("repro_torch.examples.lm_pretrain", "--ckpt-dir", pre,
                      tag="lmtrain lm_pretrain")
    if not text.rstrip().endswith("ok"):
        raise AssertionError("lmtrain lm_pretrain did not end with ok")
    shutil.rmtree(pre, ignore_errors=True)
    log(f"lmtrain launcher: failed at step {LM_LAUNCH_FAIL}, resumed at 50, its step-{sa} "
        f"checkpoint ({n_leaves} leaves) equal byte for byte to an uninterrupted run's; "
        f"lm_pretrain's loss fell")


def lm_train_phase(smi, dev="cuda") -> dict:
    """21. LM training on the card: (a) stablelm-3b whole, timed, and (a')
    with grad_accum 2 over twice the batch; (b) moonshot-v1-16b-a3b's width
    at LM_MOE_LAYERS layers with its logits_chunk 8; (c) card = CPU and the
    variants' gates; (d) bit-equal reruns and resume; (e) the launcher and
    lm_pretrain."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models import transformer as ttr

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # phase 20's configurations: stablelm-3b whole with its own remat full,
    # grad_accum 1 and logits_chunk 0; moonshot's width at LM_MOE_LAYERS
    # layers with its logits_chunk 8
    dense, moe = lm_configs()
    found = {}
    t0 = time.perf_counter()
    bundle = build_bundle(dense, make_test_mesh(1, 1, device=dev))
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    state = ttr.TrainState(model, bundle.optimizer(model))
    torch.cuda.synchronize()
    log(f"lmtrain {dense.arch}: {dense.param_count / 1e9:.3f} B parameters and their f32 "
        f"moments ({torch.cuda.memory_allocated() / 2**30:.2f} GiB) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    found["dense"] = lm_train_run("lmtrain dense", dense, state, LM_TRAIN_BATCH, LM_TRAIN_STEPS,
                                  dev)
    lm_train_report("lmtrain dense", dense, found["dense"], smi)
    found["dense"].update(lm_train_breakdown("lmtrain dense", dense, state, LM_TRAIN_BATCH,
                                             found["dense"]["step_ms"], smi))
    accum = dataclasses.replace(dense, grad_accum=2)
    found["accum"] = lm_train_run("lmtrain accum", accum, state, 2 * LM_TRAIN_BATCH,
                                  LM_ACCUM_STEPS, dev)
    lm_train_report("lmtrain accum", accum, found["accum"], smi)
    log(f"lmtrain grad_accum 2 over [{2 * LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}]: peak "
        f"{found['accum']['peak_gib']:.2f} GiB against {found['dense']['peak_gib']:.2f} at "
        f"grad_accum 1 over [{LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}]")
    del bundle, model, state
    torch.cuda.empty_cache()

    bundle = build_bundle(moe, make_test_mesh(1, 1, device=dev))
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    state = ttr.TrainState(model, bundle.optimizer(model))
    found["moe"] = lm_train_run("lmtrain moe", moe, state, LM_MOE_TRAIN_BATCH,
                                LM_MOE_TRAIN_STEPS, dev, count_routing=True)
    lm_train_report("lmtrain moe", moe, found["moe"], smi)
    del bundle, model, state
    torch.cuda.empty_cache()

    for what, cfg, accum_gate in (("lmtrain dense gate", dense, True),
                                  ("lmtrain moe gate", moe, False)):
        gate = dataclasses.replace(cfg, n_layers=LM_GATE_LAYERS, dtype="float32")
        found[what.split()[1] + "_gate"] = lm_train_gate(what, gate, dev, accum=accum_gate)
        torch.cuda.empty_cache()
    for what, cfg, resume in (("lmtrain dense rerun", dense, True),
                              ("lmtrain moe rerun", moe, False)):
        lm_train_determinism(what, dataclasses.replace(cfg, n_layers=LM_GATE_LAYERS), dev,
                             resume=resume)
        torch.cuda.empty_cache()
    lm_launch_phase()
    log(f"lmtrain phase {time.perf_counter() - t_phase:.1f} s; {smi}")
    return found


# ---------------------------------------------------------------- recsys

REC_ARCHS = ("deepfm", "autoint", "mind", "dlrm-rm2")
# (a): timed runs after one untimed run, each equal to it bit for bit
REC_SERVE_RUNS = {"serve_p99": 10, "serve_bulk": 3, "retrieval_cand": 2}
REC_TRAIN_STEPS = 3                   # a warm-up and two timed steps
REC_GATE_VOCAB = 100_000              # (b): every width the CONFIG's, the tables cut
REC_GATE_SERVE, REC_GATE_CANDIDATES, REC_GATE_TRAIN = 512, 100_000, 4_096
REC_SERVE_ATOL, REC_TRAIN_ATOL = 1e-5, 1e-4
# a metric (loss, grad_norm) is held to the tolerance times max(1, |value|):
# DimeNet's random-init grad_norm of ~3,600 has an f32 step of 2.4e-4
REC_GATE_TX = dict(lr=1e-2, eps=1e-3)  # tests/test_torch_recsys.py's: a gate, not a flat 2·lr
REC_LAUNCH = ("deepfm", "dlrm-rm2")    # (d)


def rec_flops(cfg, b: int) -> float:
    """A forward's operations over ``b`` examples: 2 a multiply-add of every
    product (the MLPs, AutoInt's projections and attention, DLRM's pairwise
    dots over all (F+1)² pairs, MIND's bilinear map, routing and head), the
    FM term's 4·F·dim. Gathers and bag sums are counted as bytes."""
    def mlp(sizes):
        return sum(2 * a * c for a, c in zip(sizes[:-1], sizes[1:]))

    f, d = cfg.n_sparse, cfg.embed_dim
    if cfg.interaction == "fm":
        per = mlp((f * d, *cfg.mlp, 1)) + 4 * f * d
    elif cfg.interaction == "self-attn":
        da, per = cfg.d_attn * cfg.n_heads, 0
        for i in range(cfg.n_attn_layers):
            per += 4 * 2 * f * (d if i == 0 else da) * da + 2 * 2 * f * f * da
        per += mlp((f * da, 1))
    elif cfg.interaction == "multi-interest":
        t, k = cfg.hist_len, cfg.n_interests
        per = (2 * t * d * d + cfg.capsule_iters * 2 * 2 * k * t * d
               + k * mlp((d, 2 * d, d)) + 2 * k * d)
    else:
        per = mlp(tuple(cfg.bot_mlp)) + 2 * (f + 1) ** 2 * d + mlp(
            ((f + 1) * f // 2 + cfg.bot_mlp[-1], *cfg.top_mlp))
    return float(per) * b


def rec_bytes(cfg, b: int, n_params: int, n_table: int, train: bool) -> float:
    """The bytes a step over ``b`` examples must move: its inputs and the
    rows it gathers (MIND: T + 1 rows an example; DeepFM's wide rows too),
    every non-table parameter once, the scores; in training the gathered
    rows' gradients written, and over every parameter a read of the
    gradient for the global norm and AdamW's read of the parameter, the
    gradient and both moments and write of the parameter and both moments
    (8 passes of 4 bytes)."""
    f, d, nnz = cfg.n_sparse, cfg.embed_dim, cfg.nnz
    if cfg.interaction == "multi-interest":
        rows = b * (cfg.hist_len + 1) * d * 4
        inputs = b * (cfg.hist_len * 8 + 4)
    else:
        rows = b * f * nnz * (d + (1 if cfg.interaction == "fm" else 0)) * 4
        inputs = b * (f * nnz + cfg.n_dense) * 4
    total = inputs + rows + (n_params - n_table) * 4 + b * 4 + b * 4
    if train:
        total += rows + 8 * 4 * n_params
    return float(total)


def rec_bound(cfg, b: int, n_params: int, n_table: int, train: bool) -> dict:
    ops = rec_flops(cfg, b) * (3 if train else 1)       # backward: twice the forward
    nbytes = rec_bytes(cfg, b, n_params, n_table, train)
    t_ops, t_bytes = ops / PEAK_OPS["float32"], nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes
                else "bytes", gflop=ops / 1e9, gbytes=nbytes / 1e9)


def rec_batches(cfg, shape, mesh, seeds):
    """data/smoke's recsys batches of ``shape``, one a seed, on the card."""
    from repro_torch.data.smoke import make_smoke_inputs

    return [make_smoke_inputs(cfg, shape, mesh, seed=s)["batch"] for s in seeds]


def metric_err(a, b) -> float:
    """Largest |a - b| / max(1, |b|) over two metric tensors."""
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def host_ms(fn) -> tuple:
    """(fn's result, its ms on the host clock between synchronizes)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def same_out(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a if isinstance(a, tuple) else (a,),
                                                 b if isinstance(b, tuple) else (b,)))


def rec_full(arch, dev, smi) -> dict:
    """(a) ``arch`` at its full CONFIG: each serve shape timed after an
    untimed run (every timed output equal to it bit for bit), then
    train_batch: a warm-up and two timed steps; dlrm-rm2's step taken
    apart."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models import recsys
    from repro_torch.models.api import TrainState
    from repro_torch.train import optimizer as opt

    cfg, shapes = get_config(arch)
    mesh = make_test_mesh(1, 1, device=dev)
    bundle = build_bundle(cfg, mesh)
    model, t_init = host_ms(lambda: bundle.init(torch.Generator(device=dev).manual_seed(0)))
    n_params = sum(p.numel() for p in model.parameters())
    n_table = sum(model[k].numel() for k in ("tables", "wide") if k in model.defs)
    log(f"recsys {arch}: {n_params / 1e6:.2f} M parameters ({n_table / 1e6:.2f} M in the "
        f"tables, {4 * n_params / 2**30:.2f} GiB f32) made on the card in {t_init:.0f} ms")
    found = {"n_params": n_params}
    for shape in shapes:
        b = shape["batch"] if shape.kind != "retrieval" else shape["n_candidates"]
        fn = bundle.step(shape).fn
        if shape.kind == "rec_train":
            continue
        t0 = time.perf_counter()
        (batch,) = rec_batches(cfg, shape, mesh, [1])
        t_data = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        first, _ = host_ms(lambda: fn(model, batch))
        times = []
        for _ in range(REC_SERVE_RUNS[shape.name]):
            out, ms = host_ms(lambda: fn(model, batch))
            if not same_out(out, first):
                raise AssertionError(f"recsys {arch} {shape.name}: a rerun differs")
            times.append(ms)
        peak = torch.cuda.max_memory_allocated() / 2**30
        score = first[0] if shape.kind == "retrieval" else first
        if not bool(torch.isfinite(score).all()):
            raise AssertionError(f"recsys {arch} {shape.name}: scores not finite")
        if shape.kind == "retrieval":
            ids = first[1]
            if ids.dtype != torch.int32 or ids.numel() != 100 or ids.unique().numel() != 100:
                raise AssertionError(f"recsys {arch}: retrieval ids {ids.dtype}, "
                                     f"{ids.unique().numel()} distinct")
        ms = float(np.median(times))
        bound = rec_bound(cfg, b, n_params, n_table, train=False)
        found[shape.name] = dict(ms=ms, ex_s=b / ms * 1e3, peak_gib=peak, **bound)
        log(f"recsys {arch} {shape.name} [{b}]: median {ms:.3f} ms of {len(times)} "
            f"({b / ms * 1e3:,.0f} examples/s), each equal bit for bit to an untimed run; "
            f"bound {bound['bound_ms']:.3f} ms by {bound['bound_by']} ({bound['gflop']:.1f} "
            f"GFLOP at 67 TFLOP/s, {bound['gbytes']:.2f} GB at 3.35 TB/s); peak {peak:.2f} GiB "
            f"(chunks of {recsys.SERVE_CHUNK} rows); inputs made in {t_data:.1f} s; {smi}")
        del batch, first, out, score
    shape = next(s for s in shapes if s.kind == "rec_train")
    b = shape["batch"]
    batches = rec_batches(cfg, shape, mesh, range(2, 2 + REC_TRAIN_STEPS))
    state = TrainState(model, bundle.optimizer(model))
    fn = bundle.step(shape).fn
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for batch in batches:
        (_, m), ms = host_ms(lambda: fn(state, batch))
        times.append(ms)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"recsys {arch} train: metrics {metrics}")
    ms = float(np.median(times[1:]))
    bound = rec_bound(cfg, b, n_params, n_table, train=True)
    found["train_batch"] = dict(ms=ms, warmup_ms=times[0], ex_s=b / ms * 1e3, peak_gib=peak,
                                metrics=metrics, **bound)
    log(f"recsys {arch} train_batch [{b}]: median {ms:.1f} ms a step of {len(times) - 1} after a "
        f"warm-up of {times[0]:.1f} ({b / ms * 1e3:,.0f} examples/s); bound "
        f"{bound['bound_ms']:.3f} ms by {bound['bound_by']} ({bound['gflop']:.1f} GFLOP, "
        f"{bound['gbytes']:.2f} GB); peak {peak:.2f} GiB; loss "
        f"{[round(m['loss'], 5) for m in metrics]}, grad_norm "
        f"{[round(m['grad_norm'], 5) for m in metrics]}; {smi}")
    if arch == "dlrm-rm2":
        model_, tx = state
        batch = batches[-1]

        def fwd_bwd():
            loss = recsys.bce_loss(recsys.forward(model_, batch), batch["label"])
            return torch.autograd.grad(loss, tx.params)

        grads, fb_ms = host_ms(fwd_bwd)
        (clipped, _), clip_ms = host_ms(lambda: opt.clip_by_global_norm(grads, 1.0))
        del grads
        _, adam_ms = host_ms(lambda: tx.update(clipped))
        del clipped
        found["parts"] = dict(fwd_bwd_ms=fb_ms, clip_ms=clip_ms, adamw_ms=adam_ms)
        log(f"recsys {arch} a train step's parts alone: forward + backward {fb_ms:.1f} ms, "
            f"the clip {clip_ms:.1f} ms, AdamW {adam_ms:.1f} ms ({len(tx.params)} tensors, "
            f"{n_params / 1e9:.3f} B parameters); the step {ms:.1f} ms; {smi}")
    del state, model, bundle, batches
    torch.cuda.empty_cache()
    return found


def rec_gate(arch, dev) -> dict:
    """(b) ``arch`` at its full widths with vocab_per_field REC_GATE_VOCAB,
    one set of parameters on the card and the CPU: serve scores of
    REC_GATE_SERVE examples within REC_SERVE_ATOL, retrieval over
    REC_GATE_CANDIDATES candidates (the top 100's values within
    REC_SERVE_ATOL, ids equal up to ties: where they differ, the CPU's score
    of the card's id equals the CPU's value of that rank within it), one
    train step of REC_GATE_TRAIN examples (metrics and updated parameters
    within REC_TRAIN_ATOL, the metrics relative to max(1, |value|)); (c)
    that step run twice on the card from one state, equal bit for bit."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import recsys
    from repro_torch.models.api import ShapeSpec, TrainState, adamw

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch)[0], vocab_per_field=REC_GATE_VOCAB)
    meshes = {d: make_test_mesh(1, 1, device=d) for d in (dev, "cpu")}
    init = recsys.init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    models = {dev: init, "cpu": copy.deepcopy(init).to("cpu")}

    def inputs(shape, seed):
        (b,) = rec_batches(cfg, shape, meshes["cpu"], [seed])
        return {dev: {k: v.to(dev) for k, v in b.items()}, "cpu": b}

    serve = inputs(ShapeSpec("gate_serve", "rec_serve", {"batch": REC_GATE_SERVE}), 7)
    s = {d: recsys.make_serve_step(cfg, meshes[d])(models[d], serve[d]).cpu() for d in meshes}
    serve_err = float((s[dev] - s["cpu"]).abs().max())
    cands = inputs(ShapeSpec("gate_retrieval", "retrieval",
                             {"batch": 1, "n_candidates": REC_GATE_CANDIDATES}), 8)
    top = {d: [t.cpu() for t in recsys.make_serve_step(cfg, meshes[d], topk=100)(
        models[d], cands[d])] for d in meshes}
    scores = recsys.make_serve_step(cfg, meshes["cpu"])(models["cpu"], cands["cpu"])
    (cv, ci), (hv, hi) = top[dev], top["cpu"]
    differ = ci != hi
    ret_err = float((cv - hv).abs().max())
    tie_err = float((scores[ci[differ].long()] - hv[differ]).abs().max()) if differ.any() else 0.0
    if not (serve_err <= REC_SERVE_ATOL and ret_err <= REC_SERVE_ATOL and tie_err <= REC_SERVE_ATOL
            and ci.unique().numel() == 100):
        raise AssertionError(f"recsys {arch} gate: card != CPU: serve {serve_err}, retrieval "
                             f"values {ret_err}, {int(differ.sum())} ids differ by {tie_err}")
    train = inputs(ShapeSpec("gate_train", "rec_train", {"batch": REC_GATE_TRAIN}), 9)
    step = {d: recsys.make_train_step(cfg, meshes[d]) for d in meshes}

    def one_step(d, model):
        _, m = step[d](TrainState(model, adamw(model, **REC_GATE_TX)), train[d])
        return torch.stack([m["loss"], m["grad_norm"]]).cpu(), model

    runs = [one_step(dev, copy.deepcopy(init)) for _ in range(2)]
    if not torch.equal(runs[0][0], runs[1][0]) or not all(
            torch.equal(x, y) for x, y in zip(runs[0][1].parameters(), runs[1][1].parameters())):
        raise AssertionError(f"recsys {arch}: two runs of one train step on the card differ")
    m_cpu, cpu_after = one_step("cpu", models["cpu"])
    m_err = metric_err(runs[0][0], m_cpu)
    p_err = max(float((x.detach().cpu() - y.detach()).abs().max())
                for x, y in zip(runs[0][1].parameters(), cpu_after.parameters()))
    if not (m_err <= REC_TRAIN_ATOL and p_err <= REC_TRAIN_ATOL):
        raise AssertionError(f"recsys {arch} gate: train step card != CPU: metrics "
                             f"{runs[0][0].tolist()} vs {m_cpu.tolist()}, parameters by {p_err}")
    log(f"recsys {arch} gate (vocab_per_field {REC_GATE_VOCAB}, full widths): card = CPU: "
        f"serve [{REC_GATE_SERVE}] within {serve_err:.3g}, retrieval over "
        f"{REC_GATE_CANDIDATES} candidates: top-100 values within {ret_err:.3g}, "
        f"{int(differ.sum())} ids differ (ties, within {tie_err:.3g}); train step "
        f"[{REC_GATE_TRAIN}] metrics within {m_err:.3g}, parameters within {p_err:.3g} "
        f"(tolerances {REC_SERVE_ATOL}, {REC_TRAIN_ATOL}); a step run twice on the card equal "
        f"bit for bit ({time.perf_counter() - t0:.1f} s)")
    del runs, models, init
    torch.cuda.empty_cache()
    return dict(serve_err=serve_err, retrieval_err=ret_err, ids_differ=int(differ.sum()),
                metrics_err=m_err, params_err=p_err)


def recsys_phase(smi, dev="cuda") -> dict:
    """22. The recsys family on the card: (a) each arch at its full CONFIG
    (``rec_full``); (b), (c) card = CPU and reruns (``rec_gate``); (d) the
    launcher's restart at deepfm and dlrm-rm2."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    found = {}
    for arch in REC_ARCHS:
        found[arch] = rec_full(arch, dev, smi)
        found[arch]["gate"] = rec_gate(arch, dev)
    for arch in REC_LAUNCH:
        sa, n_leaves = launcher_restart(arch, f"recsys {arch} train")
        log(f"recsys {arch} launcher: failed at step {LM_LAUNCH_FAIL}, resumed at 50, its "
            f"step-{sa} checkpoint ({n_leaves} leaves) equal byte for byte to an "
            f"uninterrupted run's")
    log(f"recsys phase {time.perf_counter() - t_phase:.1f} s; {smi}")
    return found


# ---------------------------------------------------------------- graph

GRAPH_SHAPES = ("full_graph_sm", "molecule")   # the two the reference's data path can build
GRAPH_STEPS = 4                                # a warm-up and three timed steps
GRAPH_ATOL = 1e-4


def graph_flops(cfg, n_nodes: int, n_edges: int, n_trip: int, d_feat: int) -> dict:
    """A forward's operations (2 a multiply-add) at these counts: the node
    projection, the edge embedding, and per block the triplet basis map,
    the kj projection, the bilinear maps, the two edge updates, the output
    map and node projection; the readout. Returns the forward's total and
    the blocks' part (recomputed once more in backward under remat full)."""
    h, r, s, nbl = cfg.d_hidden, cfg.n_radial, cfg.n_spherical, cfg.n_bilinear
    embed = (2 * n_nodes * (d_feat or 16) * h + 2 * n_edges * r * h + 2 * n_edges * 3 * h * h
             + 2 * n_nodes * h * h + 2 * n_nodes * h)
    block = (2 * n_trip * s * r * nbl + 2 * n_trip * h * h + nbl * (2 * n_trip * h * h
             + 2 * n_trip * h) + 2 * 2 * n_edges * h * h + 2 * n_edges * r * h
             + 2 * n_nodes * h * h)
    return dict(forward=float(embed + cfg.n_blocks * block), blocks=float(cfg.n_blocks * block))


def graph_step_once(cfg, shape, model, batch, dev):
    """One train step of ``model`` (updated in place) under REC_GATE_TX's
    AdamW: (loss, grad_norm) on the CPU."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models.api import TrainState, adamw

    fn = build_bundle(cfg, make_test_mesh(1, 1, device=dev)).step(shape).fn
    _, m = fn(TrainState(model, adamw(model, **REC_GATE_TX)), batch)
    return torch.stack([m["loss"], m["grad_norm"]]).cpu()


def graph_phase(smi, dev="cuda") -> dict:
    """23. DimeNet's CONFIG on the card: (a) full_graph_sm and molecule from
    build_graph_batch, a warm-up and three timed steps each; (b) one step
    on molecule card = CPU (the metrics relative to max(1, |value|)); (c)
    remat none = full and a step run twice, bit for bit. Each shape's step
    is profiled once more: device busy and the top operators."""
    import copy
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.smoke import make_smoke_inputs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models import dimenet
    from repro_torch.models.api import TrainState

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, shapes = get_config("dimenet")
    mesh = make_test_mesh(1, 1, device=dev)
    bundle = build_bundle(cfg, mesh)
    found = {}
    for shape in (s for s in shapes if s.name in GRAPH_SHAPES):
        t0 = time.perf_counter()
        batch = make_smoke_inputs(cfg, shape, mesh, seed=0)["batch"]
        t_data = time.perf_counter() - t0
        n_nodes = shape["n_nodes"] * shape.dims.get("batch", 1)
        counts = {k: (int(batch[m].sum()), int(batch[m].numel()))
                  for k, m in (("edges", "edge_mask"), ("triplets", "trip_mask"))}
        model = bundle.init(torch.Generator(device=dev).manual_seed(0), shape)
        state = TrainState(model, bundle.optimizer(model))
        fn = bundle.step(shape).fn
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(GRAPH_STEPS):
            (_, m), ms = host_ms(lambda: fn(state, batch))
            times.append(ms)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"graph {shape.name}: losses {losses}")
        wall, busy, top = lm_profile(lambda: fn(state, batch))
        ms = float(np.median(times[1:]))
        fl = graph_flops(cfg, n_nodes, counts["edges"][0], counts["triplets"][0], shape["d_feat"])
        ops = 3 * fl["forward"] + fl["blocks"]
        bound_ms = 1e3 * ops / PEAK_OPS["float32"]
        trip_s = counts["triplets"][0] / ms * 1e3
        found[shape.name] = dict(ms=ms, warmup_ms=times[0], triplets_s=trip_s, bound_ms=bound_ms,
                                 gflop=ops / 1e9, peak_gib=peak, counts=counts, losses=losses)
        log(f"graph  {shape.name}: {n_nodes} nodes (d_feat {shape['d_feat']}), edges "
            f"{counts['edges'][0]} real of {counts['edges'][1]}, triplets "
            f"{counts['triplets'][0]} real of {counts['triplets'][1]} (batch made in "
            f"{t_data:.1f} s); median {ms:.2f} ms a step of {GRAPH_STEPS - 1} after a warm-up of "
            f"{times[0]:.1f} ({trip_s:,.0f} triplets/s); bound {bound_ms:.4f} ms by operations "
            f"({ops / 1e9:.2f} GFLOP at 67 TFLOP/s: the forward, a backward of two, the blocks "
            f"recomputed); peak {peak:.3f} GiB; loss {[round(v, 4) for v in losses]}; {smi}")
        log(f"graph  {shape.name} profile of one step: wall {wall:.1f} ms, device busy "
            f"{busy:.1f} ms; top operators (device ms, calls): "
            + ", ".join(f"{k} {ms:.1f} ({n})" for k, ms, n in top))
        found[shape.name].update(profile_wall_ms=wall, busy_ms=busy, top=top)
        del state, model
    shape = next(s for s in shapes if s.name == "molecule")
    batch = make_smoke_inputs(cfg, shape, make_test_mesh(1, 1, device="cpu"), seed=1)["batch"]
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    init = dimenet.init_params(cfg, 0, torch.Generator(device=dev).manual_seed(1), dev)
    runs = {}
    for name, remat in (("full", "full"), ("again", "full"), ("none", "none")):
        model = copy.deepcopy(init)
        runs[name] = (graph_step_once(dataclasses.replace(cfg, remat=remat), shape, model,
                                      card_batch, dev), model)
    for name in ("again", "none"):
        if not torch.equal(runs[name][0], runs["full"][0]) or not all(
                torch.equal(x, y) for x, y in zip(runs[name][1].parameters(),
                                                   runs["full"][1].parameters())):
            raise AssertionError(f"graph molecule: {name} differs from remat full's step")
    cpu = copy.deepcopy(init).to("cpu")
    m_cpu = graph_step_once(cfg, shape, cpu, batch, "cpu")
    m_err = metric_err(runs["full"][0], m_cpu)
    p_err = max(float((x.detach().cpu() - y.detach()).abs().max())
                for x, y in zip(runs["full"][1].parameters(), cpu.parameters()))
    if not (m_err <= GRAPH_ATOL and p_err <= GRAPH_ATOL):
        raise AssertionError(f"graph molecule: card != CPU: metrics {runs['full'][0].tolist()} "
                             f"vs {m_cpu.tolist()}, parameters by {p_err}")
    found["gate"] = dict(metrics_err=m_err, params_err=p_err)
    log(f"graph  molecule gate: one step card = CPU (metrics within {m_err:.3g} of max(1, "
        f"|value|), parameters within {p_err:.3g}; tolerance {GRAPH_ATOL}); on the card remat "
        f"none = full and a step run twice, bit for bit")
    del runs, init, cpu
    torch.cuda.empty_cache()
    log(f"graph  phase {time.perf_counter() - t_phase:.1f} s; {smi}")
    return found


# ---------------------------------------------------------------- meshes

MESH_LM = ((1, 4), (2, 2))                    # (a), (b): (data, model)
MESH_DENSE_STEPS = 16
MESH_MOE_PREFILL, MESH_MOE_STEPS, MESH_MOE_TRAIN = (4, 2048), 16, (2, 4096)   # (b)
MESH_MOE_GATE = (2, 64)                       # (b): 2 layers in f32, prefill and train
# (b)'s gates: one a mesh, one a mode (each took 29-41 s; 1 x 4 and 2 x 2 in
# both modes ran all four through PR 25)
MESH_MOE_GATES = (((1, 4), "gather"), ((2, 2), "a2a"))
MESH_MOE_GATE_VOCAB = 32_768                  # (b)'s gate: the meshed regions never read the vocab
MESH_MOE_GATE_STEPS = 4
MESH_BF16_STEPS = 4                           # (a): tests/test_torch_transformer.py's bf16 rule
MESH_REC = ("dlrm-rm2", "mind")               # (c)
MESH_REC_MESH = (1, 4)
MESH_GRAPH_MESH = (2, 2)                      # (d)
MESH_ATOL = 1e-4


def mesh_dense(cfg, dev, smi) -> dict:
    """(a) One prefill of LM_PREFILL random tokens into an LM_CACHE-position
    cache, then MESH_DENSE_STEPS greedy decode steps on one rank; then the
    same steps over each MESH_LM mesh from that cache, fed the one-rank
    run's tokens. A meshed token must equal the one-rank token wherever the
    one-rank logits' top-2 margin exceeds twice MESH_BF16_STEPS bf16 steps
    of their largest |logit|, and every meshed logit must lie within
    MESH_BF16_STEPS such steps of the one-rank logit."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as ttr

    t0 = time.perf_counter()
    model = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    b, s = LM_PREFILL
    one = make_test_mesh(1, 1, device=dev)
    toks = torch.randint(1, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(2)).to(dev)
    logits, cache = ttr.make_prefill_step(cfg, one)(model, toks)
    whole = recut_cache(cache, one, one, b, s, LM_CACHE)
    del cache
    first = logits.argmax(-1).to(torch.int32)[:, None]

    def run(mesh, cache, feed=None):
        """Greedy steps from ``first`` (fed ``feed``'s tokens when given),
        after an untimed step at s, which the first timed step rewrites."""
        ttr.decode_logits(model, cache, first, s, mesh)
        out, secs, tok = [], [], first
        for i in range(MESH_DENSE_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg = ttr.decode_logits(model, cache, tok, s + i, mesh)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            out.append(lg)
            tok = (feed[i] if feed is not None else lg.argmax(-1).to(torch.int32))[:, None]
        return torch.stack(out), secs

    ref, ref_s = run(one, whole)
    found = {"one_ms": 1e3 * float(np.median(ref_s))}
    atol = MESH_BF16_STEPS * float(ref.abs().max()) * 2.0 ** -7
    top2 = ref.float().topk(2, -1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * atol
    for dims in MESH_LM:
        mesh = make_test_mesh(*dims, device=dev)
        ranked = recut_cache(whole, one, mesh, b, LM_CACHE, LM_CACHE)
        sizes = sorted({tuple(t.shape[1:3]) for t in ranked["k"]})
        got, secs = run(mesh, ranked, ref.argmax(-1).to(torch.int32))
        del ranked
        tok = got.argmax(-1)
        wrong = int(((tok != ref.argmax(-1)) & clear).sum())
        unsure = int((~clear).sum())
        err = float((got - ref).abs().max())
        ms = 1e3 * float(np.median(secs))
        found[f"{dims[0]}x{dims[1]}"] = dict(ms=ms, logits_err=err, unsure=unsure,
                                             differ=int((tok != ref.argmax(-1)).sum()))
        log(f"meshes dense {cfg.arch} decode over {dims[0]} x {dims[1]} (cache slices [B, S] "
            f"{sizes}): {MESH_DENSE_STEPS} steps from position {s}, median {ms:.2f} ms a step "
            f"against {found['one_ms']:.2f} ms on one rank; logits within {err:.3g} of the "
            f"one-rank decode's (bf16; tolerance {atol:.3g}); tokens equal wherever the top-2 margin exceeds "
            f"{2 * atol:.3g}, {unsure} of {tok.numel()} within it left unchecked "
            f"({found[f'{dims[0]}x{dims[1]}']['differ']} of them differ); {smi}")
        if wrong:
            raise AssertionError(f"meshes dense over {dims}: {wrong} tokens with a clear margin "
                                 f"differ from the one-rank decode")
        if not err <= atol:
            raise AssertionError(f"meshes dense over {dims}: logits differ from the one-rank "
                                 f"decode's by {err}, past {atol:.3g} ({MESH_BF16_STEPS} bf16 "
                                 f"steps of their largest |logit|)")
    del whole, model
    torch.cuda.empty_cache()
    found["s"] = time.perf_counter() - t0
    return found


@contextlib.contextmanager
def counting_drops(calls: list):
    """While open, each MoE block's dropped (token, expert) pairs go into
    ``calls``: one list a batch row's block call, one count a model rank
    (each gather dispatch, in rank order; ``moe_a2a_local``'s own list).
    Each count waits for the card."""
    from repro_torch.models import layers as lm_layers

    dispatch, a2a = lm_layers.moe_dispatch_local, lm_layers.moe_a2a_local

    def counted_dispatch(x_all, router_w, e0, e_loc, top_k, capacity):
        if e0 == 0:
            calls.append([])
        return dispatch(x_all, router_w, e0, e_loc, top_k, capacity, calls[-1])

    def counted_a2a(*args):
        calls.append([])
        return a2a(*args, dropped=calls[-1])

    lm_layers.moe_dispatch_local, lm_layers.moe_a2a_local = counted_dispatch, counted_a2a
    try:
        yield calls
    finally:
        lm_layers.moe_dispatch_local, lm_layers.moe_a2a_local = dispatch, a2a


def mesh_moe_once(cfg, mesh, dev, drops: list) -> dict:
    """(b) over ``mesh`` (or one rank): a prefill of MESH_MOE_PREFILL
    random tokens (a warm-up whose dropped pairs are counted, then timed),
    MESH_MOE_STEPS decode steps from its cache, and two train steps at
    MESH_MOE_TRAIN (the first's metrics and its forward's dropped pairs,
    the second's time), each timed on the host clock; ``drops`` gets each
    MoE block's per-rank dropped pairs."""
    import math

    import numpy as np
    import torch

    from repro_torch.models import transformer as ttr
    from repro_torch.models.api import ShapeSpec

    model = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, mesh=mesh)
    b, s = MESH_MOE_PREFILL
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(1, cfg.vocab, (b, s), generator=gen).to(dev)
    prefill = ttr.make_prefill_step(cfg, mesh)
    with counting_drops([]) as calls:
        prefill(model, toks)
    drops.append(("prefill", calls))
    (logits, cache), prefill_ms = host_ms(lambda: prefill(model, toks))
    n_len = s + MESH_MOE_STEPS
    full = recut_cache(cache, mesh, mesh, b, s, n_len)
    del cache
    decode = ttr.make_decode_step(cfg, mesh, b, n_len)
    tok, secs, chain = logits.argmax(-1).to(torch.int32)[:, None], [], []
    for i in range(MESH_MOE_STEPS):
        (nxt, full), ms = host_ms(lambda: decode(model, full, tok, s + i))
        secs.append(ms)
        chain.append(nxt)
        tok = nxt[:, None]
    del full
    chain = torch.stack(chain)
    if not bool(torch.isfinite(logits).all()) or not bool(((chain >= 0) & (chain < cfg.vocab)).all()):
        raise AssertionError(f"meshes moe {mesh.shape}: prefill logits or decode tokens invalid")
    tb, ts = MESH_MOE_TRAIN
    batch_toks = torch.randint(1, cfg.vocab, (tb, ts + 1), generator=gen).to(dev)
    batch = {"tokens": batch_toks[:, :-1], "labels": batch_toks[:, 1:]}
    state = ttr.TrainState(model, ttr.adamw(model, **LM_GATE_TX))
    step = ttr.make_train_step(cfg, mesh)
    with counting_drops([]) as calls:
        _, metrics = step(state, batch)             # counted; the second step is timed
    n_fwd = len(calls) // 2 if cfg.remat == "full" else len(calls)
    drops.append(("train", calls[:n_fwd]))
    _, train_ms = host_ms(lambda: step(state, batch))
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"meshes moe {mesh.shape}: train metrics {metrics}")
    out = dict(prefill_ms=prefill_ms, decode_ms=float(np.median(secs)), train_ms=train_ms,
               metrics=metrics, tokens=chain.cpu())
    del state, model
    torch.cuda.empty_cache()
    return out


def mesh_drops(drops) -> str:
    """Each model rank's dropped pairs summed over the MoE blocks (and the
    batch rows), per kind."""
    parts = []
    for kind, calls in drops:
        if not calls:
            continue
        per = [sum(c[j] for c in calls) for j in range(len(calls[0]))]
        parts.append(f"{kind} {per}")
    return "; ".join(parts)


def mesh_moe_gate(cfg, dims, dev) -> dict:
    """(b)'s card = CPU gate over ``dims``: one f32 model on the card and a
    copy on the CPU (their ranks on each), a prefill of MESH_MOE_GATE
    within LM_F32_ATOL, MESH_MOE_GATE_STEPS decode steps token for token
    (both fed the CPU's tokens), one train step at MESH_MOE_GATE within
    LM_TRAIN_ATOL of max(1, |value|), and the updated parameters."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as ttr
    from repro_torch.models.api import copy_leaves

    b, s = MESH_MOE_GATE
    sides = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        mesh = make_test_mesh(*dims, device=d)
        model = ttr.LM(cfg, mesh=mesh)
        sides[side] = [model, mesh, d]
    ttr_init = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev,
                               mesh=sides["card"][1])
    for model, _, _ in sides.values():
        copy_leaves(model, ttr_init)
    del ttr_init
    toks = torch.randint(1, cfg.vocab, (b, s + 1), generator=torch.Generator().manual_seed(3))
    out = {}
    for side, (model, mesh, d) in sides.items():
        logits, cache = ttr.make_prefill_step(cfg, mesh)(model, toks[:, :-1].to(d))
        out[side] = [logits.cpu(), cache]
    err = float((out["card"][0] - out["cpu"][0]).abs().max())
    if err > LM_F32_ATOL:
        raise AssertionError(f"meshes moe gate {dims} {cfg.moe_impl}: prefill logits differ by "
                             f"{err}")
    tok = out["cpu"][0].argmax(-1).to(torch.int32)[:, None]
    for i in range(MESH_MOE_GATE_STEPS):
        got = {}
        for side, (model, mesh, d) in sides.items():
            pos = s - MESH_MOE_GATE_STEPS + i      # rewrites the prompt's last positions
            got[side], _ = ttr.make_decode_step(cfg, mesh, b, s)(model, out[side][1],
                                                                   tok.to(d), pos)
        if not torch.equal(got["card"].cpu(), got["cpu"]):
            raise AssertionError(f"meshes moe gate {dims}: decode step {i} differs")
        tok = got["cpu"][:, None]
    metrics = {}
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for side, (model, mesh, d) in sides.items():
        state = ttr.TrainState(model, ttr.adamw(model, **LM_GATE_TX))
        _, m = ttr.make_train_step(cfg, mesh)(state, {k: v.to(d) for k, v in batch.items()})
        metrics[side] = torch.stack([m[k] for k in LM_METRICS]).cpu()
        del state
    m_err = metric_err(metrics["card"], metrics["cpu"])
    p_err = lm_param_err(sides["cpu"][0], sides["card"][0])
    if not (m_err <= LM_TRAIN_ATOL and p_err <= LM_TRAIN_ATOL):
        raise AssertionError(f"meshes moe gate {dims} {cfg.moe_impl}: train metrics "
                             f"{metrics['card'].tolist()} vs {metrics['cpu'].tolist()}, "
                             f"parameters by {p_err}")
    return dict(logits_err=err, metrics_err=m_err, params_err=p_err)


def mesh_moe(cfg, dev, smi) -> dict:
    """(b) moonshot's width at LM_MOE_LAYERS layers: each meshed run
    (``mesh_moe_once``) against the one-rank run, then the card = CPU gate
    at 2 layers in f32, its vocabulary cut to MESH_MOE_GATE_VOCAB to keep
    the CPU side short."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh

    t0 = time.perf_counter()
    found = {}
    drops = []
    one = mesh_moe_once(cfg, make_test_mesh(1, 1, device=dev), dev, drops)
    found["one"] = one
    log(f"meshes moe {cfg.arch} ({cfg.n_layers} layers, {cfg.moe.n_experts} experts top "
        f"{cfg.moe.top_k}) on one rank: prefill {MESH_MOE_PREFILL} {one['prefill_ms']:.1f} ms, "
        f"decode {one['decode_ms']:.2f} ms a step, train step {MESH_MOE_TRAIN} "
        f"{one['train_ms']:.1f} ms (loss {one['metrics']['loss']:.4f}); dropped pairs "
        f"{mesh_drops(drops)}; {smi}")
    for dims in MESH_LM:
        for impl in ("gather", "a2a"):
            drops = []
            mcfg = dataclasses.replace(cfg, moe_impl=impl)
            run = mesh_moe_once(mcfg, make_test_mesh(*dims, device=dev), dev, drops)
            same = float((run["tokens"] == one["tokens"]).float().mean())
            found[f"{dims[0]}x{dims[1]} {impl}"] = dict(run, tokens=None, same_tokens=same)
            log(f"meshes moe over {dims[0]} x {dims[1]}, {impl}: prefill {run['prefill_ms']:.1f} "
                f"ms ({one['prefill_ms']:.1f} on one rank), decode {run['decode_ms']:.2f} ms a "
                f"step ({one['decode_ms']:.2f}), train step {run['train_ms']:.1f} ms "
                f"({one['train_ms']:.1f}), loss {run['metrics']['loss']:.4f} "
                f"({one['metrics']['loss']:.4f}); decode tokens equal to one rank's on "
                f"{100 * same:.1f}% (capacities follow the per-rank batch); dropped pairs "
                f"per rank: {mesh_drops(drops)}; {smi}")
    gate = dataclasses.replace(cfg, n_layers=LM_GATE_LAYERS, dtype="float32",
                               vocab=MESH_MOE_GATE_VOCAB)
    log(f"meshes moe runs {time.perf_counter() - t0:.1f} s")
    for dims, impl in MESH_MOE_GATES:
        t1 = time.perf_counter()
        g = mesh_moe_gate(dataclasses.replace(gate, moe_impl=impl), dims, dev)
        found[f"gate {dims[0]}x{dims[1]} {impl}"] = g
        log(f"meshes moe gate over {dims[0]} x {dims[1]}, {impl}, {LM_GATE_LAYERS} layers "
            f"f32, vocab {gate.vocab}: card = CPU, prefill {MESH_MOE_GATE} logits within "
            f"{g['logits_err']:.3g} (tolerance {LM_F32_ATOL}), {MESH_MOE_GATE_STEPS} decode "
            f"steps token for token, train metrics within {g['metrics_err']:.3g} of max(1, |value|) and "
            f"parameters within {g['params_err']:.3g} (tolerance {LM_TRAIN_ATOL}); "
            f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    found["s"] = time.perf_counter() - t0
    return found


def mesh_psum(cfg, dev) -> dict:
    """(e) Two pod ranks, each with the gradients of layer 0's weights for
    one half of a MESH_MOE_TRAIN batch of (b)'s model on one rank, in f32,
    reduced twice by ``compressed_psum_pod``: after each call every rank's
    error buffer must equal its x - deq (x = g + the previous buffer), and
    the result the mean of the ranks' deq."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as ttr
    from repro_torch.train import grad_compress as gc

    model = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    leaves = list(model.layers[0].values())
    tb, ts = MESH_MOE_TRAIN
    toks = torch.randint(1, cfg.vocab, (tb, ts + 1),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    grads = []
    for p in range(2):
        loss, _, _ = ttr.loss_fn(model, toks[p:p + 1, :-1], toks[p:p + 1, 1:])
        grads.append([g.float() for g in torch.autograd.grad(loss, leaves)])
    del model, leaves
    mesh = make_test_mesh(1, 1, pod=2, device=dev)
    err = [gc.init_error_buffers(g) for g in grads]
    n = sum(g.numel() for g in grads[0])
    for call in range(2):
        red, new = gc.compressed_psum_pod(grads, err, mesh)
        for i in range(len(grads[0])):
            deqs = []
            for p in range(2):
                x = grads[p][i] + err[p][i]
                q, scale = gc._quantize(x)
                deqs.append(q.float() * scale)
                if not torch.equal(new[p][i], x - deqs[-1]):
                    raise AssertionError(f"meshes psum call {call}: rank {p} leaf {i}: the error "
                                         f"buffer is not x - deq")
            if not torch.equal(red[i], (deqs[0] + deqs[1]) / 2):
                raise AssertionError(f"meshes psum call {call}: leaf {i} is not the ranks' mean")
        err = new
    resid = max(float(e.abs().max()) for e in err[0])
    ratio = gc.compression_ratio_bytes(grads[0])
    del grads, err, red, new
    torch.cuda.empty_cache()
    return dict(elements=n, residual_max=resid, ratio=ratio["ratio"])


def mesh_recsys(arch, dev, smi) -> dict:
    """(c) ``arch`` whole on one rank and over MESH_REC_MESH (the meshed
    model's leaves copied from the one-rank model's): serve_bulk equal bit
    for bit (timed, after an untimed call), then two train_batch steps each
    from those weights, the first's metrics within MESH_ATOL of max(1,
    |value|), the second timed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle, recsys
    from repro_torch.models.api import TrainState, copy_leaves

    cfg, shapes = get_config(arch)
    serve_shape = next(s for s in shapes if s.name == "serve_bulk")
    train_shape = next(s for s in shapes if s.name == "train_batch")
    torch.cuda.reset_peak_memory_stats()
    one_mesh, mesh = make_test_mesh(1, 1, device=dev), make_test_mesh(*MESH_REC_MESH, device=dev)
    one = build_bundle(cfg, one_mesh).init(torch.Generator(device=dev).manual_seed(0))
    meshed = recsys.new_model(cfg, mesh=mesh)
    copy_leaves(meshed, one)
    slices = [(tuple(t.shape), t.numel() * t.element_size() / 2**30, str(t.device))
              for t in meshed.shards("tables")]
    out = {}
    sbatch = rec_batches(cfg, serve_shape, one_mesh, [1])[0]
    for name, model, m in (("one", one, one_mesh), ("meshed", meshed, mesh)):
        fn = build_bundle(cfg, m).step(serve_shape).fn
        fn(model, sbatch)
        out[name], ms = host_ms(lambda: fn(model, sbatch))
        out[name + "_serve_ms"] = ms
    if not torch.equal(out["one"], out["meshed"]):
        raise AssertionError(f"meshes {arch}: meshed serve scores differ from one rank's by "
                             f"{float((out['one'] - out['meshed']).abs().max())}")
    tbatch = rec_batches(cfg, train_shape, one_mesh, [2])[0]

    def train(model, m):
        """The first step's metrics, the second's time."""
        bundle = build_bundle(cfg, m)
        state = TrainState(model, bundle.optimizer(model))
        fn = bundle.step(train_shape).fn
        _, met = fn(state, tbatch)
        _, ms = host_ms(lambda: fn(state, tbatch))
        return torch.stack([met["loss"], met["grad_norm"]]).cpu(), ms

    metrics = {}
    metrics["one"], out["one_train_ms"] = train(one, one_mesh)
    del one
    torch.cuda.empty_cache()
    metrics["meshed"], out["meshed_train_ms"] = train(meshed, mesh)
    del meshed
    torch.cuda.empty_cache()
    m_err = metric_err(metrics["meshed"], metrics["one"])
    if m_err > MESH_ATOL:
        raise AssertionError(f"meshes {arch}: train metrics {metrics['meshed'].tolist()} vs "
                             f"{metrics['one'].tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    found = dict(serve_one_ms=out["one_serve_ms"], serve_ms=out["meshed_serve_ms"],
                 train_one_ms=out["one_train_ms"], train_ms=out["meshed_train_ms"],
                 metrics_err=m_err, peak_gib=peak, slices=slices)
    log(f"meshes {arch} over {MESH_REC_MESH[0]} x {MESH_REC_MESH[1]}: table slices "
        + ", ".join(f"{sh} {gib:.3f} GiB on {d}" for sh, gib, d in slices)
        + f"; serve_bulk [{serve_shape['batch']}] equal to one rank's bit for bit, "
        f"{found['serve_ms']:.1f} ms ({found['serve_one_ms']:.1f} on one rank); train step "
        f"[{train_shape['batch']}] {found['train_ms']:.1f} ms ({found['train_one_ms']:.1f}), "
        f"metrics within {m_err:.3g} of max(1, |value|) (tolerance {MESH_ATOL}); peak "
        f"{peak:.2f} GiB; {smi}")
    return found


def mesh_graph(dev, smi) -> dict:
    """(d) DimeNet's CONFIG on full_graph_sm over MESH_GRAPH_MESH: one
    train step on the card (timed, after an untimed step from a copy),
    against the same step on the CPU over a CPU mesh (metrics and
    parameters within MESH_ATOL of max(1, |value|)); the one-rank step on
    the batch laid out for one shard is logged beside it, not held: the
    reference's meshed edge gather adds every rank's partial gather into
    every rank's triplets, so its meshed model is another function."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.smoke import make_smoke_inputs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models.api import TrainState

    cfg, shapes = get_config("dimenet")
    shape = next(s for s in shapes if s.name == "full_graph_sm")
    mesh = make_test_mesh(*MESH_GRAPH_MESH, device=dev)
    cpu_mesh = make_test_mesh(*MESH_GRAPH_MESH, device="cpu")
    batch = make_smoke_inputs(cfg, shape, cpu_mesh, seed=0)["batch"]
    one_batch = make_smoke_inputs(cfg, shape, make_test_mesh(1, 1, device="cpu"), seed=0)["batch"]
    init = build_bundle(cfg, mesh).init(torch.Generator(device=dev).manual_seed(0), shape)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    res = {}
    for name, m, model, b in (
            ("warm", mesh, copy.deepcopy(init), card_batch),
            ("card", mesh, copy.deepcopy(init), card_batch),
            ("cpu", cpu_mesh, copy.deepcopy(init).to("cpu"), batch),
            ("one", make_test_mesh(1, 1, device=dev), copy.deepcopy(init),
             {k: v.to(dev) for k, v in one_batch.items()})):
        bundle = build_bundle(cfg, m)
        state = TrainState(model, bundle.optimizer(model))
        fn = bundle.step(shape).fn
        (_, met), ms = host_ms(lambda: fn(state, b))
        res[name] = (torch.stack([met["loss"], met["grad_norm"]]).cpu(), model, ms)
    m_err = metric_err(res["card"][0], res["cpu"][0])
    p_err = max(float((x.detach().cpu() - y.detach()).abs().max())
                for x, y in zip(res["card"][1].parameters(), res["cpu"][1].parameters()))
    if not (m_err <= MESH_ATOL and p_err <= MESH_ATOL):
        raise AssertionError(f"meshes graph: card != CPU over {MESH_GRAPH_MESH}: "
                             f"{res['card'][0].tolist()} vs {res['cpu'][0].tolist()}, "
                             f"parameters by {p_err}")
    gap = metric_err(res["card"][0], res["one"][0])
    found = dict(ms=res["card"][2], one_ms=res["one"][2], metrics_err=m_err, params_err=p_err,
                 one_rank_gap=gap, loss=float(res["card"][0][0]), one_loss=float(res["one"][0][0]))
    log(f"meshes graph dimenet full_graph_sm over {MESH_GRAPH_MESH[0]} x {MESH_GRAPH_MESH[1]}: "
        f"one train step {found['ms']:.1f} ms ({found['one_ms']:.1f} ms on one rank); card = CPU "
        f"(metrics within {m_err:.3g} of max(1, |value|), parameters within {p_err:.3g}; "
        f"tolerance {MESH_ATOL}); loss {found['loss']:.5f} against {found['one_loss']:.5f} on "
        f"one rank ({gap:.3g} apart: the reference's meshed edge gather is another function); "
        f"{smi}")
    del res, init
    torch.cuda.empty_cache()
    return found


def mesh_models_phase(smi, dev="cuda") -> dict:
    """24. The meshed models on the card, every rank on it: (a) the dense
    LM's decode, (b) the MoE LM's gather and a2a paths and their card = CPU
    gate, (c) the row-sharded recsys tables, (d) edge-sharded DimeNet, (e)
    the pod-axis gradient compression."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dense, moe = lm_configs()                 # phase 20's
    found = {"dense": mesh_dense(dense, dev, smi)}
    log(f"meshes dense {found['dense']['s']:.1f} s")
    found["moe"] = mesh_moe(moe, dev, smi)
    log(f"meshes moe {found['moe']['s']:.1f} s")
    t0 = time.perf_counter()
    psum = mesh_psum(moe, dev)
    found["psum"] = psum
    log(f"meshes psum: compressed_psum_pod over 2 pod ranks, {psum['elements']:,} gradient "
        f"elements of (b)'s layer 0 a rank, two calls: every error buffer equal to x - deq bit "
        f"for bit and the result the ranks' mean; largest residual {psum['residual_max']:.3g}; "
        f"{psum['ratio']:.1f}x fewer bytes than f32; {time.perf_counter() - t0:.1f} s")
    for arch in MESH_REC:
        t0 = time.perf_counter()
        found[arch] = mesh_recsys(arch, dev, smi)
        log(f"meshes {arch} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    found["graph"] = mesh_graph(dev, smi)
    log(f"meshes graph {time.perf_counter() - t0:.1f} s")
    log(f"meshes phase {time.perf_counter() - t_phase:.1f} s; {smi}")
    return found


# ---------------------------------------------------------------- the last modules

LAST_TOY_RECALL, LAST_TOY_GAP = 0.9, 0.01      # (a): floor, and the most below phase 4's f32
LAST_DENSE_QUERIES = 128                        # (b): partition_topk's q_batch
# (c): the dry run's predicted peak over the card's measured one, a band
# stated before the first card run (on the CPU, 56.38 GiB against 56.81 and
# 43.43 against 43.56)
LAST_DRYRUN_BAND = (0.8, 1.25)


def last_toy_tier(ds, gti, recall_f32, smi, dev) -> dict:
    """(a) The bf16 toy tier built and served through the unchanged engine;
    returns the kernels-line entry of l2_topk_qbuf on its plane and the
    engine's serve operands."""
    import numpy as np
    import torch

    from repro_torch.core.metrics import recall_at_k
    from repro_torch.kernels import dedup_topk as dd_mod, l2_topk as l2_mod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pq_adc as adc_mod
    from repro_torch.kernels import rerank_topk as rr_mod
    from repro_torch.serving import tiers
    from repro_torch.serving.api import BuildConfig
    from repro_torch.serving.engine import LiraEngine

    @tiers.register
    class Bf16ToyTier(tiers.F32Tier):
        """The f32 scan over a bfloat16 vector plane, declared here alone."""

        name = "bf16_toy"
        aliases = ()

        def store_specs(self, cfg):
            specs = super().store_specs(cfg)
            specs["vectors"] = (specs["vectors"][0], torch.bfloat16)
            return specs

        def build_store(self, cfg, store_h, *, generator=None):
            store, cfg = super().build_store(cfg, store_h, generator=generator)
            store["vectors"] = store["vectors"].to(torch.bfloat16)
            return store, cfg

    t0 = time.perf_counter()
    eng = LiraEngine.build(ds.base, BuildConfig(tier="bf16_toy", **MAIN_BUILD), device=dev)
    torch.cuda.synchronize()
    log(f"last   bf16_toy build {time.perf_counter() - t0:.1f} s | capacity {eng.cfg.capacity} | "
        f"vectors {eng.store['vectors'].dtype} "
        f"{eng.store['vectors'].numel() * 2 / 2**30:.3f} GiB | {eng.cfg}")
    if eng.cfg.tier != "bf16_toy" or eng.store["vectors"].dtype != torch.bfloat16:
        raise AssertionError(f"bf16_toy: tier {eng.cfg.tier}, vectors {eng.store['vectors'].dtype}")
    counters = {"l2_topk_qbuf": l2_mod, "dedup_topk": dd_mod, "pq_adc_topk_qbuf": adc_mod,
                "rerank_topk_qbuf": rr_mod}
    ids, launches = serve(eng, ds.queries, "bf16_toy", counters, len(ds.base), "last   bf16_toy")
    require_launched("last   bf16_toy", launches, ("l2_topk_qbuf", "dedup_topk"))
    if launches["pq_adc_topk_qbuf"] or launches["rerank_topk_qbuf"]:
        raise AssertionError(f"bf16_toy launched a quantized stage: {launches}")
    rec = recall_at_k(ids, gti, 100)
    log(f"last   bf16_toy recall@100 {rec:.4f} against exact ground truth (phase 4's f32 "
        f"{recall_f32:.4f})")
    if rec < LAST_TOY_RECALL or recall_f32 - rec > LAST_TOY_GAP:
        raise AssertionError(f"bf16_toy recall@100 {rec:.4f}: floor {LAST_TOY_RECALL}, within "
                             f"{LAST_TOY_GAP} of f32's {recall_f32:.4f}")
    # one batch's scan operands, and its stats
    seen = []
    scan_fn = kops.l2_topk_qbuf

    def capture(*args, **kw):
        seen.append(args)
        return scan_fn(*args, **kw)

    kops.l2_topk_qbuf = capture
    try:
        res = eng.search(ds.queries[:BATCH])
    finally:
        kops.l2_topk_qbuf = scan_fn
    qp, qb, vec, cid, k = seen[0]
    if res.stats.tier != "bf16_toy" or vec.dtype != torch.bfloat16 or qp.dtype != torch.bfloat16:
        raise AssertionError(f"bf16_toy: stats tier {res.stats.tier}, scan over {vec.dtype}")
    cuda_vs_ref(eng, ds.queries[:BATCH], "bf16_toy", "last   bf16_toy")
    from repro_torch import testing as rt

    err = compare_l2("l2_topk_qbuf bf16 plane", qp, qb, vec, cid, k)
    ms = time_ms(lambda: l2_mod.l2_topk_qbuf(qp, qb, vec, cid, k), 10)
    plain_ms = time_ms(lambda: kops.l2_topk_qbuf(qp, qb, vec, cid, k, impl="ref"), 3, 1)
    bound = bound_entry(*l2_bound(qp, qb, vec, cid, k))
    log(f"last   kernel l2_topk_qbuf on the bf16 plane (q_pad {list(qp.shape)}, qbuf "
        f"{list(qb.shape)}, {int(rt.occupied(qp, qb).sum())} occupied slots): {ms:.3f} ms "
        f"(plain {plain_ms:.3f} ms, bound {bound[0]:.3f} ms by {bound[1]}), max abs err "
        f"{err:.3g}; launch {l2_mod.occupancy(vec, k)}; {smi}")
    entry = kernel_entry(
        "l2_topk_qbuf/bf16", "l2_topk_qbuf.cu", "src/repro/kernels/l2_topk.py:247",
        launches["l2_topk_qbuf"], err, ms, plain_ms, bound,
        {"q_pad": list(qp.shape), "qbuf": list(qb.shape), "cands": list(vec.shape), "k": k,
         "dtype": "bfloat16", "occupied_slots": int(rt.occupied(qp, qb).sum()),
         "recall_at_100": rec})
    dense_q = torch.as_tensor(np.asarray(ds.queries[:LAST_DENSE_QUERIES]), device=dev)
    return entry, (qp, qb, vec, cid, k, dense_q)


def last_sweep(operands, smi, dev) -> dict:
    """(b) The G sweep at lira-ann-q's store shape; every G that fits must
    give the calculator's launch's bits."""
    import torch

    from repro_torch.core import retrieval as ret
    from repro_torch.kernels import autotune
    from repro_torch.kernels import l2_topk as l2_mod

    qp, qb, vec, cid, k, dense_q = operands
    b, cap, d = vec.shape
    vec32 = vec.float()
    found = {}
    for dtype, ops_ in ((torch.float32, (qp.float(), qb, vec32, cid)),
                        (torch.bfloat16, (qp, qb, vec, cid))):
        g = autotune.autotune_l2_qbuf(cap, d, k, dtype=dtype, operands=ops_)
        found[f"l2 {dtype}"] = rec = autotune.records()[-1]
        log(f"last   sweep l2_topk_qbuf {str(dtype).replace('torch.', '')} at the serve path's "
            f"dispatch (qbuf {list(qb.shape)}, store [{b}, {cap}, {d}], k {k}): each G "
            + ", ".join(f"{gg} {1e3 * t:.3f} ms" for gg, t in rec["timings_s"].items())
            + f"; the calculator's {1e3 * rec['default_s']:.3f} ms; refused {rec['refused']}; "
            f"winner {g}, cached; bits equal to the calculator's {rec['same_bits']}")
    q_row, q_cap = qp.shape[0] - 1, qb.shape[1]
    g = autotune.autotune_pq_adc_qbuf(cap, 16, 256, 4 * k, b_loc=b, q_cap=q_cap, q_row=q_row,
                                      device=dev)
    found["adc"] = rec = autotune.records()[-1]
    log(f"last   sweep pq_adc_topk_qbuf at m 16, ks 256, k {4 * k} on synthetic operands of "
        f"the store's shape (qbuf [{b}, {q_cap}], codes [{b}, {cap}, 16] uint8, every slot a "
        f"random row): each G " + ", ".join(f"{gg} {1e3 * t:.3f} ms"
                                            for gg, t in rec["timings_s"].items())
        + f"; the calculator's {1e3 * rec['default_s']:.3f} ms; refused {rec['refused']}; "
        f"winner {g}, cached; bits equal to the calculator's {rec['same_bits']}")
    # partition_topk's dense dispatch: 128 queries to every partition
    for dtype, store in ((torch.float32, vec32), (torch.bfloat16, vec)):
        dq, dbuf = ret.dense_dispatch(dense_q.to(dtype), b)
        base = l2_mod.l2_topk_qbuf(dq, dbuf, store, cid, k)
        rec = {"timings_s": {}, "refused": {}, "same_bits": {},
               "default_s": time_ms(lambda: l2_mod.l2_topk_qbuf(dq, dbuf, store, cid, k), 5) / 1e3}
        for gg in autotune.L2_GROUPS:
            plan = l2_mod.group_plan(d, k, store.element_size(), gg, dev)
            if not plan["fits"]:
                rec["refused"][str(gg)] = f"{plan['smem_bytes']} B of shared memory"
                continue
            out = l2_mod.l2_topk_qbuf(dq, dbuf, store, cid, k, group=gg)
            rec["same_bits"][str(gg)] = all(torch.equal(x, y) for x, y in zip(out, base))
            rec["timings_s"][str(gg)] = time_ms(
                lambda: l2_mod.l2_topk_qbuf(dq, dbuf, store, cid, k, group=gg), 5) / 1e3
        found[f"dense {dtype}"] = rec
        log(f"last   sweep l2_topk_qbuf {str(dtype).replace('torch.', '')} at the dense dispatch "
            f"of {LAST_DENSE_QUERIES} queries (qbuf {list(dbuf.shape)}): each G "
            + ", ".join(f"{gg} {1e3 * t:.3f} ms" for gg, t in rec["timings_s"].items())
            + f"; the calculator's {1e3 * rec['default_s']:.3f} ms; refused {rec['refused']}; "
            f"bits equal to the calculator's {rec['same_bits']}; {smi}")
    del vec32
    torch.cuda.empty_cache()
    for what, rec in found.items():
        if not rec["same_bits"] or not all(rec["same_bits"].values()):
            raise AssertionError(f"sweep {what}: a group changed the bits: {rec['same_bits']}")
    return found


def last_dryrun(peaks: dict, smi) -> dict:
    """(c) The dry run (meta tensors, one device) of phase 21's and phase
    22's train steps against the card's peaks."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.api import ShapeSpec

    found = {}
    lm_cfg, _ = get_config("stablelm-3b")
    rec_cfg, _ = get_config("dlrm-rm2")
    cells = (
        ("stablelm-3b", ShapeSpec("train_4k", "train", {"seq_len": LM_TRAIN_SEQ,
                                                        "global_batch": LM_TRAIN_BATCH}),
         "lm_train_bound", 1e12 * lm_train_bound(lm_cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)["tflop"]),
        ("dlrm-rm2", ShapeSpec("train_batch", "rec_train", {"batch": 65_536}),
         "3 x rec_flops", 3 * rec_flops(rec_cfg, 65_536)),
    )
    for arch, shape, bound_name, bound_flops in cells:
        res = dryrun.run_cell(arch, shape, "one", verbose=False)
        mem = res["memory"]
        ratio = mem["per_device_total"] / 2**30 / peaks[arch]
        found[arch] = dict(predicted_gib=mem["per_device_total"] / 2**30, measured_gib=peaks[arch],
                           ratio=ratio, flops=res["ops"]["flops_per_device"],
                           model_flops=res["model_flops_global"], bound_flops=bound_flops,
                           trace_s=res["lower_s"], fits_80g=mem["fits_80g"])
        log(f"last   dryrun {arch} {shape.kind} {dict(shape.dims)} over one device: predicted "
            f"peak {mem['per_device_total'] / 2**30:.2f} GiB (parameters "
            f"{mem['parameters'] / 2**30:.2f}, optimizer {mem['optimizer'] / 2**30:.2f}, inputs "
            f"{mem['inputs'] / 2**30:.2f}, activations {mem['activation_peak'] / 2**30:.2f}) "
            f"against the card's {peaks[arch]:.2f} GiB (max_memory_allocated in its phase): "
            f"{ratio:.3f} x; fits {mem['device_memory_of']} ({mem['device_memory']} B): "
            f"{mem['fits_80g']}; counted {res['ops']['flops_per_device']:.4e} FLOPs against "
            f"model_flops {res['model_flops_global']:.4e} and {bound_name} {bound_flops:.4e}; "
            f"bytes {res['ops']['bytes_per_device']:.4e}; traced in {res['lower_s']:.1f} s; "
            f"largest at the peak {res['top_buffers'][:3]}; {smi}")
        lo, hi = LAST_DRYRUN_BAND
        if not lo <= ratio <= hi:
            raise AssertionError(f"dryrun {arch}: predicted / measured peak {ratio:.3f} outside "
                                 f"{LAST_DRYRUN_BAND}")
    return found


def last_modules_phase(smi, ds, gti, recall_f32: float, peaks: dict, dev="cuda"):
    """25. The last modules: (a) the tier registry's extension point, (b)
    the group autotuner, (c) the dry run against the card. Returns the
    kernels-line entry of l2_topk_qbuf on the bf16 plane and what each part
    found."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    entry, operands = last_toy_tier(ds, gti, recall_f32, smi, dev)
    log(f"last   (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    found = {"sweep": last_sweep(operands, smi, dev)}
    log(f"last   (b) {time.perf_counter() - t0:.1f} s")
    del operands
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    found["dryrun"] = last_dryrun(peaks, smi)
    log(f"last   (c) {time.perf_counter() - t0:.1f} s")
    log(f"last   phase {time.perf_counter() - t_phase:.1f} s; {smi}")
    return entry, found


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
    from repro_torch.kernels import rerank_topk as rr_mod
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
    counters = {"l2_topk_qbuf": l2_mod, "dedup_topk": dd_mod, "pq_adc_topk_qbuf": adc_mod,
                "rerank_topk_qbuf": rr_mod}
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
            ("residual_pq", eng, "residual_pq",
             ("pq_adc_topk_qbuf", "rerank_topk_qbuf", "dedup_topk")),
            ("residual_pq rerank 16", deep, "residual_pq",
             ("pq_adc_topk_qbuf", "rerank_topk_qbuf", "dedup_topk"))):
        captured.clear()
        what = f"main   {path}"
        ids_out, launches = serve(engine, ds.queries, tier, counters, n_base, what)
        inputs[path] = (dict(captured), launches)
        require_launched(what, launches, needs)
        if tier == "f32" and (launches["pq_adc_topk_qbuf"] or launches["rerank_topk_qbuf"]):
            raise AssertionError(f"{what}: a quantized stage launched: {launches}")
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
    require_launched("pq     pq", launches_pq, ("pq_adc_topk_qbuf", "rerank_topk_qbuf", "dedup_topk"))
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
    # stage 2 of both paths (rk = 400 and 1,600) at the operands the batch
    # gave it; phase 27's entry carries these beside lira-ann-q's
    main_rerank = []
    for path in ("residual_pq", "residual_pq rerank 16"):
        r_args, _ = inputs[path][0]["rerank_topk_qbuf"]
        err_r, eq_r = compare_rerank(f"rerank_topk_qbuf {path} inputs", *r_args)
        ms_r = time_ms(lambda: rr_mod.rerank_topk_qbuf(*r_args), 10)
        plain_r = time_ms(lambda: kops.rerank_topk_qbuf(*r_args, impl="ref"), 2, 1)
        bound_r = bound_entry(*rerank_bound(*r_args))
        n_occ = int(rt.occupied(r_args[0], r_args[1]).sum())
        log(f"kernel rerank_topk_qbuf at the {path} path's stage 2 (rk {r_args[4].shape[2]}, "
            f"{n_occ} occupied slots): within l2_atol of its plain version (max abs err "
            f"{err_r:.3g}), {eq_r} rows' ids equal element for element; {ms_r:.3f} ms (plain "
            f"{plain_r:.3f} ms, bound {bound_r[0]:.3f} ms by {bound_r[1]})")
        main_rerank.append({"path": path, "rk": r_args[4].shape[2], "occupied_slots": n_occ,
                            "rows_ids_equal": eq_r, "max_abs_err": err_r, "ms": ms_r,
                            "plain_ms": plain_r, "bound_ms": bound_r[0],
                            "bound_by": bound_r[1]})
    del r_args
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
    kernels.append(u8_phase(smi))
    kernels.append(rerank_phase(smi))
    kernels[-1]["shapes"]["main_paths"] = main_rerank
    clustered = cluster_phase(ds, counters, gti, recall, smi)
    examples_phase()
    lm_phase(smi)
    lm_trained = lm_train_phase(smi)
    rec_found = recsys_phase(smi)
    graph_phase(smi)
    mesh_models_phase(smi)
    entry, _ = last_modules_phase(smi, ds, gti, recall["f32"], {
        "stablelm-3b": lm_trained["dense"]["peak_gib"],
        "dlrm-rm2": rec_found["dlrm-rm2"]["train_batch"]["peak_gib"]})
    kernels.append(entry)
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
