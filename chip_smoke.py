#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LIRA on one NVIDIA card, end to end.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device  — the card's name and power limit, torch and CUDA versions;
  2. build   — nvcc compiles every kernel under src/repro_torch/csrc/, all at once;
  3. edges   — each kernel against its plain PyTorch version on the card, at
               repro_torch.testing's edge cases (padding ids, k > pool,
               duplicate ids, exact ties, non-finite distances, bf16 store,
               empty slots, buckets and rows with nothing valid) at the main
               path's widths, under the same rule the tests use;
  4. main    — the main path at the lira-ann widths (dim 128, B = 1024
               partitions, k = 100, nprobe_max = 64) over 1,000,000 base points
               and 10,000 queries (SIFT1M's scale): LiraEngine.build on the
               card, then 10 batches of 1,000 queries through search(); the
               kernels' launch counters are zeroed just before and read just
               after; recall@100 against exact ground truth; one batch served
               again with impl="ref" must agree;
  5. kernels — each kernel against its plain version on the inputs the main
               path gave it, timed with CUDA events beside its bound.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_BASE, N_QUERIES, BATCH = 1_000_000, 10_000, 1_000
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


def compare_dedup(what, dists, ids, k) -> float:
    """Kernel vs plain version: no arithmetic, so equal element for element."""
    from repro_torch import testing as rt
    from repro_torch.kernels import ops as kops

    d_k, i_k = kops.dedup_topk(dists, ids, k, impl="cuda")
    d_p, i_p = kops.dedup_topk(dists, ids, k, impl="ref")
    return rt.assert_topk_match(d_k, i_k, d_p, i_p, 0.0, exact_ids=True, what=what)


def edge_cases(dev) -> None:
    """Each kernel against its plain version at every edge case, at the main
    path's widths (d = 128, k = 100; merge rows of 102,400 entries)."""
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


def bound_entry(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_batch(eng, queries) -> None:
    """One served batch under torch.profiler: device time by operation, and
    the device's busy share of the batch's wall time (the profiler's own
    host overhead lengthens the wall time, so the share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.search(queries)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        eng.search(queries)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op also reports its kernels' time
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    if not ops:
        log("profile torch.profiler saw no device time: not measured")
        return
    log(f"profile one batch of {len(queries)}: wall {wall_ms:.2f} ms under the profiler, "
        f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:100]}")


# ---------------------------------------------------------------- phases

def main(n_base: int = N_BASE, n_queries: int = N_QUERIES) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import testing as rt
    from repro_torch.core import ground_truth as gt
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.data.synthetic import make_vector_dataset
    from repro_torch.kernels import _build, dedup_topk as dd_mod, l2_topk as l2_mod
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.api import BuildConfig
    from repro_torch.serving.engine import LiraEngine
    from repro_torch.utils.device import resolve_device

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)
    dev = resolve_device("cuda")
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

    # 4. main path
    t0 = time.perf_counter()
    ds = make_vector_dataset(n=n_base, n_queries=n_queries, dim=128, seed=0)
    log(f"main   dataset {ds.base.shape} + {ds.queries.shape} in {time.perf_counter() - t0:.1f} s")
    captured = {}

    def capture(name, fn):
        def wrapped(*args, **kw):
            captured.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return wrapped

    orig = (kops.l2_topk_qbuf, kops.dedup_topk)
    kops.l2_topk_qbuf = capture("l2_topk_qbuf", kops.l2_topk_qbuf)
    kops.dedup_topk = capture("dedup_topk", kops.dedup_topk)
    l2_mod.launches = dd_mod.launches = 0
    t0 = time.perf_counter()
    eng = LiraEngine.build(ds.base, BuildConfig(n_partitions=1024, k=100, nprobe_max=64,
                                                eta=0.03, sigma=0.5, train_frac=0.1),
                           device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    store_bytes = sum(t.numel() * t.element_size() for t in eng.store.values())
    log(f"main   build {build_s:.1f} s | capacity {eng.cfg.capacity} | store "
        f"{store_bytes / 2**30:.3f} GiB on the card | {eng.cfg}")
    ids_out, nprobe, overflow, batch_s = [], [], 0, []
    for s in range(0, n_queries, BATCH):
        t1 = time.perf_counter()
        res = eng.search(ds.queries[s:s + BATCH])
        batch_s.append(time.perf_counter() - t1)
        ids_out.append(res.ids)
        nprobe.append(res.nprobe_eff)
        overflow += res.overflow
    launches = {"l2_topk_qbuf": l2_mod.launches, "dedup_topk": dd_mod.launches}
    kops.l2_topk_qbuf, kops.dedup_topk = orig
    ids_out = np.concatenate(ids_out)
    qps = n_queries / sum(batch_s)
    log(f"main   served {n_queries} queries in {len(batch_s)} batches of {BATCH} "
        f"(bucket {res.stats.bucket}, impl {res.stats.impl}): {qps:.1f} QPS over all batches, "
        f"{BATCH / float(np.median(batch_s)):.1f} QPS at the median batch "
        f"({1e3 * float(np.median(batch_s)):.1f} ms; first {1e3 * batch_s[0]:.1f} ms)")
    log(f"main   mean nprobe_eff {float(np.concatenate(nprobe).mean()):.3f} | overflow {overflow} "
        f"| launches over {len(batch_s)} batches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if ids_out.shape != (n_queries, 100) or (ids_out >= n_base).any():
        raise AssertionError(f"bad result ids: shape {ids_out.shape}")
    if any(len(set(r[r >= 0].tolist())) != int((r >= 0).sum()) for r in ids_out):
        raise AssertionError("duplicate ids in a result row")
    t0 = time.perf_counter()
    _, gti = gt.exact_knn(ds.queries, ds.base, 100, device=dev)
    recall = recall_at_k(ids_out, gti, 100)
    log(f"main   recall@100 {recall:.4f} against exact ground truth on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    # this configuration reaches ~0.96 on an H100; a broken build, dispatch,
    # scan or merge lands far below
    if n_base == N_BASE and recall < 0.9:
        raise AssertionError(f"recall@100 {recall:.4f} < 0.9")

    q0 = ds.queries[:BATCH]
    r_cuda, r_ref = eng.search(q0, impl="cuda"), eng.search(q0, impl="ref")
    atol = rt.l2_atol(q0, eng.store["vectors"], eng.store["ids"])
    err = rt.assert_topk_match(r_cuda.dists, r_cuda.ids, r_ref.dists, r_ref.ids, atol,
                               what="main batch cuda vs ref")
    if not (np.array_equal(r_cuda.nprobe_eff, r_ref.nprobe_eff)
            and r_cuda.overflow == r_ref.overflow
            and r_cuda.stats.dedup_hits == r_ref.stats.dedup_hits):
        raise AssertionError("main batch: nprobe_eff / overflow / dedup_hits differ")
    log(f"main   one batch impl=cuda vs impl=ref: agree (max abs err {err:.3g}, atol {atol:.3g})")

    profile_batch(eng, ds.queries[BATCH:2 * BATCH])

    # 5. kernels at the main path's inputs
    kernels = []
    (qp, qb, vec, ids, k), _ = captured["l2_topk_qbuf"]
    err = compare_l2("l2_topk_qbuf main-path inputs", qp, qb, vec, ids, k)
    ms = time_ms(lambda: l2_mod.l2_topk_qbuf(qp, qb, vec, ids, k), 10)
    plain_ms = time_ms(lambda: kops.l2_topk_qbuf(qp, qb, vec, ids, k, impl="ref"), 3, 1)
    bound_ms, bound_by = bound_entry(*l2_bound(qp, qb, vec, ids, k))
    kernels.append({"name": "l2_topk_qbuf", "route": "cuda",
                    "source": "src/repro_torch/csrc/l2_topk_qbuf.cu",
                    "replaces": "src/repro/kernels/l2_topk.py:247",
                    "launches": launches["l2_topk_qbuf"], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None,
                    "shapes": {"q_pad": list(qp.shape), "qbuf": list(qb.shape),
                               "cands": list(vec.shape), "k": k,
                               "occupied_slots": int(rt.occupied(qp, qb).sum())}})
    # one block scans one bucket: the heaviest bucket's share of the work
    # bounds what the other 131 SMs can hide
    work = rt.occupied(qp, qb).sum(1).double() * (ids >= 0).sum(1).double()
    log(f"kernel l2_topk_qbuf per-bucket work (occupied slots x valid candidates): "
        f"max {int(work.max())}, mean {float(work.mean()):.0f}, heaviest bucket "
        f"{100 * float(work.max() / work.sum()):.2f}% of the total; max occupied slots "
        f"{int(rt.occupied(qp, qb).sum(1).max())}, max valid candidates "
        f"{int((ids >= 0).sum(1).max())}")
    (pd, pi, k), _ = captured["dedup_topk"]
    err = compare_dedup("dedup_topk main-path inputs", pd, pi, k)
    ms = time_ms(lambda: dd_mod.dedup_topk(pd, pi, k), 10)
    plain_ms = time_ms(lambda: kops.dedup_topk(pd, pi, k, impl="ref"), 3, 1)
    bound_ms, bound_by = bound_entry(pd.numel() * 8 + pd.shape[0] * k * 8, 0.0, PEAK_OPS["float32"])
    kernels.append({"name": "dedup_topk", "route": "cuda",
                    "source": "src/repro_torch/csrc/dedup_topk.cu",
                    "replaces": "src/repro/kernels/dedup_topk.py:137",
                    "launches": launches["dedup_topk"], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None,
                    "shapes": {"pool": list(pd.shape), "k": k,
                               "valid": int(((pi >= 0) & torch.isfinite(pd)).sum())}})
    for kern in kernels:
        log(f"kernel {kern['name']}: {kern['ms']:.3f} ms (plain {kern['plain_ms']:.3f} ms, "
            f"bound {kern['bound_ms']:.3f} ms by {kern['bound_by']}), no single PyTorch call "
            f"computes the same function")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
