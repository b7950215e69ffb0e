"""End-to-end serving example (counterpart of ``examples/serve_ann.py``):
build a LIRA index and serve batched queries through the engine's serve
step, then through the dynamic-batching front-end.

    PYTHONPATH=src python -m repro_torch.examples.serve_ann                 # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_ann --device cpu

Both tiers serve from one engine: the residual-PQ codes ride next to the f32
store, and a SearchRequest picks which tier scans it. On the card the f32
tier runs ``l2_topk_qbuf``, the residual-PQ tier ``pq_adc_topk_qbuf``, and
both merge through ``dedup_topk``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import FrontendConfig
from repro_torch.core import ground_truth as gt
from repro_torch.core.metrics import recall_at_k
from repro_torch.data.synthetic import make_vector_dataset
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.serving.api import BuildConfig, SearchRequest
from repro_torch.serving.engine import LiraEngine
from repro_torch.serving.frontend import simulate_open_loop
from repro_torch.serving.quantized import scan_store_bytes
from repro_torch.utils.clock import FakeClock
from repro_torch.utils.device import resolve_device


def main(device=None, *, n: int = 20_000, n_queries: int = 512, n_partitions: int = 32) -> dict:
    """Returns recall@10 of each tier and the front-end's stats."""
    dev = resolve_device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    ds = make_vector_dataset(n=n, n_queries=n_queries, dim=64, n_modes=64, seed=2)
    mesh = make_test_mesh(data=1, model=1, device=dev)

    print("building LIRA engine (kmeans → probe training → redundancy → store → PQ)…")
    t0 = time.time()
    engine = LiraEngine.build(ds.base, BuildConfig(
        n_partitions=n_partitions, k=10, eta=0.05, train_frac=0.4, epochs=5,
        nprobe_max=8, tier="residual_pq", pq_m=16, rerank=16), device=dev, mesh=mesh)
    sb = scan_store_bytes(engine.store)
    print(f"  built in {time.time()-t0:.0f}s; capacity={engine.cfg.capacity}; "
          f"residual-PQ scan store x{sb['ratio']:.1f} smaller")

    _, gti = gt.exact_knn(ds.queries, ds.base, 10, device=dev)

    recall = {}
    for label, tier in (("f32 exact scan", "f32"),
                        ("residual PQ/ADC + rerank", "residual_pq")):
        req = SearchRequest(queries=ds.queries, sigma=0.3, tier=tier)
        engine.search(req)  # warm the serve cache and the kernels
        t0 = time.time()
        res = engine.search(req)
        dt = time.time() - t0
        recall[tier] = recall_at_k(res.ids, gti, 10)
        print(f"  [{label}] {len(ds.queries)/dt:.0f} QPS ({where}); "
              f"mean nprobe={res.nprobe_eff.mean():.2f}; dropped probes="
              f"{res.overflow}; recall@10={recall[tier]:.3f}")

    # online path: single-query requests through the dynamic-batching
    # front-end; requests coalesce into pow2-bucketed batches, telemetry
    # comes back per request
    fe = engine.attach_frontend(
        FrontendConfig(max_batch=32, max_wait_ms=5.0),
        clock=FakeClock(), charge_service=True)
    for s in (8, 16, 32):   # warm the flushable buckets: steady state
        engine.search(SearchRequest(queries=ds.queries[:s], sigma=0.3,
                                    tier="residual_pq"))
    stats, pendings = simulate_open_loop(
        fe, ds.queries, rate_qps=1500.0, n_requests=128, sigma=0.3,
        tier="residual_pq")
    one = pendings[0].result()
    print(f"  [front-end @1500qps offered] p50={stats.p50_ms:.2f}ms "
          f"p99={stats.p99_ms:.2f}ms qps={stats.qps:.0f} "
          f"mean_batch={stats.mean_batch:.1f} shed={stats.shed}; first "
          f"request waited {one.stats.queue_ms:.2f}ms in a "
          f"{one.stats.batch_size}-row batch")
    return {"recall": recall, "frontend": stats}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    main(ap.parse_args().device)
