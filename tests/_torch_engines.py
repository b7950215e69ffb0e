"""Small direct-store engines of the port (no build pass), on the CPU: the
cheap fixtures the obs, front-end and mutable tests share, as the
reference's tests build theirs; and ``jax_and_port``, a small built JAX
engine beside the port's engine loaded from its save."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import LiraSystemConfig
from repro_torch.core import probing
from repro_torch.serving.engine import LiraEngine
from repro_torch.serving.quantized import build_quantized_store

CPU = torch.device("cpu")


def probing_model(dim, b, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return probing.ProbingModel(probing.ProbingConfig(dim=dim, n_partitions=b),
                                generator=gen, device="cpu")


def tier_engines(seed=11, b=4, cap=48, dim=16, k=5):
    """An f32, a pq and a residual_pq engine over one partition layout (every
    slot live, σ = -1), and 12 queries."""
    host = np.random.default_rng(seed)
    vecs = torch.from_numpy(host.normal(0, 1, (b, cap, dim)).astype(np.float32))
    ids = torch.arange(b * cap, dtype=torch.int32).reshape(b, cap)
    base = {"centroids": vecs.mean(1), "vectors": vecs, "ids": ids, "occupancy": ids >= 0}
    cfg = LiraSystemConfig(arch="t", dim=dim, n_partitions=b, capacity=cap, k=k,
                           nprobe_max=b, pq_m=4, pq_ks=16, rerank=2)
    gen = torch.Generator().manual_seed(1)
    qs = build_quantized_store(vecs, ids, m=4, ks=16, generator=gen)
    gen = torch.Generator().manual_seed(1)
    qr = build_quantized_store(vecs, ids, m=4, ks=16, residual=True,
                               centroids=base["centroids"], generator=gen)
    model = probing_model(dim, b)

    def eng(tier, store):
        return LiraEngine(cfg=dataclasses.replace(cfg, tier=tier), model=model, store=store,
                          device=CPU, sigma=-1.0)

    engines = {
        "f32": eng("f32", base),
        "pq": eng("pq", {**base, "codes": qs.codes, "codebooks": qs.codebooks}),
        "residual_pq": eng("residual_pq", {**base, "codes": qr.codes,
                                           "codebooks": qr.codebooks, "cterm": qr.cterm}),
    }
    return engines, host.normal(0, 1, (12, dim)).astype(np.float32)


def raw_engine(b=4, cap=24, dim=16, live_per_part=18, seed=3, metrics=None):
    """An f32 engine with free tail slots (so same-shape inserts have room)
    and well-separated centroids (so a row's argmin partition is clear)."""
    host = np.random.default_rng(seed)
    vecs = np.full((b, cap, dim), 1e6, np.float32)
    ids = np.full((b, cap), -1, np.int32)
    cents = host.normal(0, 1, (b, dim)).astype(np.float32) * 8.0
    for p in range(b):
        vecs[p, :live_per_part] = cents[p] + host.normal(
            0, 0.2, (live_per_part, dim)).astype(np.float32)
        ids[p, :live_per_part] = np.arange(live_per_part) + p * live_per_part
    store = {"centroids": torch.from_numpy(cents), "vectors": torch.from_numpy(vecs),
             "ids": torch.from_numpy(ids), "occupancy": torch.from_numpy(ids >= 0)}
    cfg = LiraSystemConfig(arch="t", dim=dim, n_partitions=b, capacity=cap, k=5, nprobe_max=b)
    eng = LiraEngine(cfg=cfg, model=probing_model(dim, b), store=store, device=CPU,
                     sigma=-1.0, metrics=metrics)
    return eng, cents, host


def jax_and_port(path, seed=41):
    """A JAX engine (impl="ref", residual_pq, so it serves f32 too) built
    over a small dataset and saved to ``path``, the port's engine loaded
    from that save with ``load_jax``, and the dataset's 24 queries:
    ``({"jax": engine, "torch": engine}, queries)``."""
    from repro.data import make_vector_dataset as jax_make_vector_dataset
    from repro.launch.mesh import make_test_mesh
    from repro.serving.api import BuildConfig as JaxBuildConfig
    from repro.serving.engine import LiraEngine as JaxEngine

    ds = jax_make_vector_dataset(n=1200, n_queries=24, dim=16, n_modes=8, seed=seed)
    jeng = JaxEngine.build(make_test_mesh(), ds.base, JaxBuildConfig(
        n_partitions=8, k=10, eta=0.03, train_frac=0.4, epochs=2, nprobe_max=8, pq_m=4,
        pq_ks=32, tier="residual_pq", impl="ref"))
    jeng.save(path)
    return {"jax": jeng, "torch": LiraEngine.load_jax(path, device="cpu")}, ds.queries
