"""Serving launcher (counterpart of ``python -m repro.launch.serve``): build a
LIRA index and serve query batches through an engine over a device mesh,
then through a ``LiraCluster`` (LANNS shards × replica groups, routed and
hedged dispatch) with one replica killed mid-stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --queries 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 4000

It runs on the card unless ``--device cpu`` is given. The mesh is one data
rank by two model ranks (two partition blocks), both on that device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--partitions", type=int, default=32)
    ap.add_argument("--sigma", type=float, default=0.3)
    ap.add_argument("--pods", type=int, default=2,
                    help="replicas per shard in the serving cluster")
    ap.add_argument("--shards", type=int, default=2,
                    help="LANNS level-1 shards in the serving cluster")
    ap.add_argument("--tier", default="f32", choices=("f32", "pq", "residual_pq"),
                    help="serving tier (serving/tiers.py): f32 exact scan | pq ADC "
                         "shortlist + exact rerank | residual_pq PQ over x − centroid "
                         "with per-partition LUT offsets")
    ap.add_argument("--rerank", type=int, default=8,
                    help="quantized shortlist depth r (rerank r·k per partition)")
    ap.add_argument("--auto-q-cap", action="store_true",
                    help="double q_cap_factor after persistent dispatch-bucket overflow")
    ap.add_argument("--impl", default="auto", choices=("auto", "ref", "cuda"),
                    help="kernel backend: auto takes the kernels on the card and the "
                         "plain PyTorch versions on the CPU")
    ap.add_argument("--device", default=None,
                    help="device of every rank (default the card; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the serving section into "
                         "this directory (TensorBoard / Perfetto; the serve step's "
                         "lira.probing/dispatch/scan/merge ranges)")
    ap.add_argument("--trace-out", default="",
                    help="stream host-side spans to this JSON-lines file: the index "
                         "build's stages (build.kmeans ... build.tier), then serving "
                         "(engine.*, the serve step's lira.* stages)")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import FrontendConfig
    from repro_torch.data.synthetic import make_vector_dataset
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.obs import Tracer, default_registry, profile_capture
    from repro_torch.serving.api import BuildConfig, SearchRequest
    from repro_torch.serving.cluster import ClusterConfig, LiraCluster
    from repro_torch.serving.engine import LiraEngine
    from repro_torch.serving.frontend import simulate_open_loop
    from repro_torch.serving.quantized import scan_store_bytes
    from repro_torch.utils.clock import FakeClock
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    ds = make_vector_dataset(n=args.n, n_queries=args.queries, dim=64, n_modes=64, seed=4)
    mesh = make_test_mesh(1, 2, device=dev)
    print(f"building index on {dev} (mesh {mesh.shape})…")
    tracer = Tracer(sink=args.trace_out) if args.trace_out else None
    engine = LiraEngine.build(ds.base, BuildConfig(
        n_partitions=args.partitions, k=10, eta=0.05, train_frac=0.4, epochs=5,
        tier=args.tier, rerank=args.rerank, impl=args.impl,
        auto_q_cap=args.auto_q_cap), device=dev, mesh=mesh, tracer=tracer)
    if args.tier != "f32":
        sb = scan_store_bytes(engine.store)
        print(f"  {args.tier} tier: m={engine.cfg.pq_m} ks={engine.cfg.pq_ks} "
              f"rerank={engine.cfg.rerank}; scan store x{sb['ratio']:.1f} smaller")
    print(f"serving {args.queries} queries…")
    with profile_capture(args.profile_dir):
        t0 = time.time()
        res = engine.search(SearchRequest(queries=ds.queries, sigma=args.sigma))
        dt = time.time() - t0
    print(f"  {args.queries / dt:.0f} QPS local; adaptive nprobe "
          f"mean={res.nprobe_eff.mean():.2f}; dropped probes (q_cap overflow)="
          f"{res.overflow}; dedup_hits={res.stats.dedup_hits}; "
          f"bucket={res.stats.bucket} cache_hit={res.stats.cache_hit}")
    if res.stats.stages is not None:
        breakdown = " ".join(f"{name}={ms:.2f}ms" for name, ms in res.stats.stages.items())
        print(f"  stages: {breakdown} (e2e {res.stats.latency_ms:.2f}ms)")
    if args.profile_dir:
        print(f"  profiler trace in {args.profile_dir} (TensorBoard or Perfetto)")

    # online front-end: a single-query stream through the dynamic batcher
    # (virtual clock, the real serve cost charged onto it)
    one = engine.search_one(SearchRequest(queries=ds.queries[0], sigma=args.sigma))
    print(f"  search_one: k={one.ids.shape[-1]} nprobe_eff={float(one.nprobe_eff[0]):.2f}")
    fe = engine.attach_frontend(
        FrontendConfig(max_batch=32, max_wait_ms=5.0, max_queue=256),
        clock=FakeClock(), charge_service=True)
    for s in (8, 16, 32):   # the flushable buckets, served once before timing
        engine.search(SearchRequest(queries=ds.queries[:s], sigma=args.sigma))
    try:
        stats, _ = simulate_open_loop(fe, ds.queries, rate_qps=2000.0, n_requests=256,
                                      sigma=args.sigma)
        print(f"  front-end @2000qps offered: p50={stats.p50_ms:.2f}ms "
              f"p99={stats.p99_ms:.2f}ms qps={stats.qps:.0f} "
              f"mean_batch={stats.mean_batch:.1f} shed={stats.shed}")
    finally:
        engine.frontend = None

    # a LiraCluster over the same corpus: LANNS shards × replica groups, with
    # routed and hedged dispatch and one replica killed mid-stream (its
    # in-flight batch replays; nothing is lost)
    print(f"building {args.shards}-shard × {args.pods}-replica cluster…")
    cluster = LiraCluster.build(ds.base, BuildConfig(
        n_partitions=max(8, args.partitions // args.shards), k=10, eta=0.05,
        train_frac=0.4, epochs=5, tier=args.tier, rerank=args.rerank, impl=args.impl),
        ClusterConfig(n_shards=args.shards, n_replicas=args.pods, hedge_warmup=8),
        device=dev, mesh=mesh)
    n_batches, kill_at, bs = 32, 10, 32
    rows = 0
    for j in range(n_batches):
        if j == kill_at and args.pods > 1:
            cluster.fail_replica(0, 0, inflight=True)
        sel = np.arange(j * bs, (j + 1) * bs) % len(ds.queries)
        cres = cluster.search(SearchRequest(queries=ds.queries[sel], sigma=args.sigma))
        rows += cres.dists.shape[0]
    requeued = sum(g.router.requeued for g in cluster.groups)
    hedges = sum(g.mitigator.hedges for g in cluster.groups)
    served = {f"s{r['shard']}r{r['replica']}": r["served"] for r in cluster.replica_table()}
    print(f"  cluster: {rows} rows over {n_batches} batches, served={served} "
          f"(replica (0,0) killed at batch {kill_at}: {requeued} re-queued, "
          f"{hedges} hedges, 0 lost); last merge: nprobe "
          f"mean={cres.nprobe_eff.mean():.2f} routes={cres.stats.routes}")

    # registry snapshot: the cumulative counters this process accumulated
    reg = default_registry()
    print(f"  metrics: overflow_rate={engine.overflow_rate():.4f} "
          f"searches={reg.counter('lira_engine_searches_total').total():.0f} "
          f"jit_misses={reg.counter('lira_engine_jit_cache_misses_total').total():.0f} "
          f"dedup_hits={reg.counter('lira_engine_dedup_hits_total').total():.0f}")
    if args.trace_out:
        engine.tracer.close()
        print(f"  spans streamed to {args.trace_out}")


if __name__ == "__main__":
    main()
