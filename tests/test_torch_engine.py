"""Serve parity: a JAX engine is built and saved, the port loads the same
directory with ``LiraEngine.load_jax`` on the CPU, and both search the same
queries with ``impl="ref"``.

Across σ ∈ {0.3, 0.5, 0.9} × η ∈ {0, 0.03} × {float32, bfloat16} stores at an
odd batch (37 queries, bucket 64), plus a forced q_cap overflow:
distances and ids under ``repro_torch.testing``'s rule (rtol 1e-5, atol
1e-5·max(‖q‖²+‖c‖²); ids set-equal per row except among candidates tied
within that tolerance at the k-th place), and ``nprobe_eff``, ``overflow``
and ``dedup_hits`` equal. Also what ``load_jax`` carries over (config,
parameters, store) and what it does not (the saved kernel backend).

The other way round: engines the port builds (f32, residual_pq, a bfloat16
store) are saved with ``LiraEngine.save`` and loaded by the JAX
``LiraEngine.load``, which then serves the port's answers under the same
contract; a mutated engine's save round-trips through the port's ``load``
bit for bit (planes, epoch, staleness counters). And the serve cache: its
key, its LRU bound of 32, its drop on a q_cap bump; and two builds from one
seed give one index, bit for bit.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_engines import raw_engine
from repro.data import make_vector_dataset
from repro.launch.mesh import make_test_mesh
from repro.serving.api import BuildConfig as JaxBuildConfig
from repro.serving.engine import LiraEngine as JaxEngine
from repro_torch import testing as rt
from repro_torch.core.redundancy import plan_redundancy
from repro_torch.kernels import ops as kops
from repro_torch.serving.api import BuildConfig, SearchRequest
from repro_torch.serving.engine import LiraEngine

ENGINES = {"eta0": dict(eta=0.0), "eta0.03": dict(eta=0.03),
           "bf16": dict(eta=0.03, store_dtype="bfloat16")}


@pytest.fixture(scope="module")
def dataset():
    return make_vector_dataset(n=3000, n_queries=64, dim=16, n_modes=12, seed=5)


@pytest.fixture(scope="module")
def engines(dataset, tmp_path_factory):
    """One JAX build per engine kind, saved and loaded into the port."""
    out = {}
    for name, kw in ENGINES.items():
        jeng = JaxEngine.build(make_test_mesh(), dataset.base,
                               JaxBuildConfig(n_partitions=16, k=10, epochs=2, impl="ref",
                                              **kw))
        path = tmp_path_factory.mktemp(name)
        jeng.save(path)
        out[name] = (jeng, LiraEngine.load_jax(path, device="cpu"))
    return out


def assert_same_answer(jr, tr, atol):
    np.testing.assert_array_equal(tr.nprobe_eff, np.asarray(jr.nprobe_eff))
    assert tr.overflow == jr.overflow
    assert tr.stats.dedup_hits == jr.stats.dedup_hits
    assert tr.dists.shape == np.shape(jr.dists) and tr.ids.dtype == np.int32
    rt.assert_topk_match(tr.dists, tr.ids, jr.dists, jr.ids, atol)


def atol_for(eng, q):
    return rt.l2_atol(q, eng.store["vectors"], eng.store["ids"])


def test_load_jax_carries_config_params_and_store(engines):
    jeng, teng = engines["bf16"]
    assert teng.cfg.capacity == jeng.cfg.capacity and teng.cfg.k == jeng.cfg.k
    assert teng.cfg.store_dtype == "bfloat16" and teng.cfg.eta == jeng.cfg.eta
    assert teng.store["vectors"].dtype == torch.bfloat16
    assert teng.sigma == jeng.sigma
    np.testing.assert_array_equal(teng.store["ids"].numpy(), np.asarray(jeng.store["ids"]))
    np.testing.assert_array_equal(teng.store["vectors"].float().numpy(),
                                  np.asarray(jeng.store["vectors"]).astype(np.float32))
    w = np.asarray(jeng.params["phi_p"][-1]["w"])
    np.testing.assert_array_equal(teng.model.phi_p[-1].weight.detach().numpy().T, w)


def test_load_jax_does_not_take_the_saved_kernel_backend(engines, dataset):
    """Saved with impl="ref", the engine still serves through the kernels on
    the card; only the caller's impl= picks the plain version there."""
    jeng, teng = engines["eta0"]
    assert jeng.cfg.impl == "ref" and teng.cfg.impl == "auto"
    assert kops.resolve_impl(teng.cfg.impl, torch.device("cuda")) == "cuda"
    assert teng.search(dataset.queries[:5]).stats.impl == "ref"   # plain on the CPU


@pytest.mark.parametrize("sigma", [0.3, 0.5, 0.9])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_search_matches_jax(engines, dataset, kind, sigma):
    jeng, teng = engines[kind]
    q = dataset.queries[:37]
    jr = jeng.search(q, sigma=sigma, impl="ref")
    tr = teng.search(q, sigma=sigma, impl="ref")
    assert tr.stats.bucket == jr.stats.bucket == 64
    assert_same_answer(jr, tr, atol_for(teng, q))


@pytest.mark.parametrize("kind", ["eta0", "eta0.03"])
def test_forced_overflow_matches_jax(engines, dataset, kind):
    """σ = -1 probes every one of nprobe_max partitions; q_cap_factor 0.1
    leaves 8 slots per partition, so probes are dropped — the same ones."""
    jeng, teng = engines[kind]
    jeng = dataclasses.replace(jeng, cfg=dataclasses.replace(jeng.cfg, q_cap_factor=0.1))
    teng = dataclasses.replace(teng, cfg=dataclasses.replace(teng.cfg, q_cap_factor=0.1))
    q = dataset.queries[:37]
    jr, tr = jeng.search(q, sigma=-1.0, impl="ref"), teng.search(q, sigma=-1.0, impl="ref")
    assert tr.overflow > 0
    assert_same_answer(jr, tr, atol_for(teng, q))


def test_search_request_overrides_and_buckets(engines, dataset):
    _, teng = engines["eta0.03"]
    q = dataset.queries
    first = teng.search(SearchRequest(queries=q[:37], k=5, sigma=0.3))
    again = teng.search(q[:37], k=5, sigma=0.3)
    np.testing.assert_array_equal(first.ids, again.ids)
    assert first.ids.shape == (37, 5) and first.stats.bucket == 64
    assert first.stats.k == 5 and first.stats.sigma == 0.3
    assert teng._batch_bucket(1) == 8 and teng._batch_bucket(65) == 128
    with pytest.raises(TypeError):
        teng.search(SearchRequest(queries=q[:3]), sigma=0.5)
    with pytest.raises(ValueError, match="lacks"):  # an f32 store has no PQ codes
        teng.search(q[:3], tier="pq")


def test_auto_q_cap_doubles_after_persistent_overflow(engines, dataset):
    _, teng = engines["eta0"]
    teng = dataclasses.replace(teng, cfg=dataclasses.replace(teng.cfg, q_cap_factor=0.1,
                                                             auto_q_cap=True))
    q = dataset.queries[:37]
    assert teng.search(q, sigma=-1.0).overflow > 0
    assert teng.cfg.q_cap_factor == 0.1
    teng.search(q, sigma=-1.0)
    assert teng.cfg.q_cap_factor == 0.2


# ------------------------------------------------ the port's saves, read by JAX

TORCH_ENGINES = {"f32": dict(tier="f32"), "residual_pq": dict(tier="residual_pq"),
                 "bf16": dict(tier="residual_pq", store_dtype="bfloat16")}


@pytest.fixture(scope="module")
def torch_saves(dataset, tmp_path_factory):
    """One port build per kind, saved, and the JAX engine loaded from it."""
    out = {}
    for name, kw in TORCH_ENGINES.items():
        teng = LiraEngine.build(dataset.base, BuildConfig(n_partitions=16, k=10, epochs=2,
                                                          eta=0.03, pq_m=4, pq_ks=32, **kw),
                                device="cpu")
        path = tmp_path_factory.mktemp(f"torch-{name}")
        teng.save(path)
        out[name] = (JaxEngine.load(path, make_test_mesh()), teng, path)
    return out


@pytest.mark.parametrize("sigma", [0.3, 0.9])
@pytest.mark.parametrize("kind", list(TORCH_ENGINES))
def test_jax_load_of_a_torch_save_serves_the_torch_answer(torch_saves, dataset, kind, sigma):
    jeng, teng, _ = torch_saves[kind]
    assert jeng.cfg.tier == teng.cfg.tier and jeng.cfg.capacity == teng.cfg.capacity
    assert jeng.cfg.store_dtype == teng.cfg.store_dtype and jeng.sigma == teng.sigma
    q = dataset.queries[:37]
    jr = jeng.search(q, sigma=sigma, impl="ref")
    tr = teng.search(q, sigma=sigma, impl="ref")
    assert_same_answer(jr, tr, atol_for(teng, q))


def test_torch_save_writes_the_reference_layout(torch_saves):
    """The manifest and leaves are what JAX writes: impl carried only as
    "auto" or "ref", bf16 planes upcast to f32, LATEST naming the step."""
    jeng, teng, path = torch_saves["bf16"]
    meta = json.loads((path / "step_0000000000" / "manifest.json").read_text())
    assert (path / "LATEST").read_text() == "0"
    assert meta["n_leaves"] == len(list((path / "step_0000000000").glob("leaf_*.p0.npy")))
    assert meta["extra"]["config"]["impl"] == "auto" and meta["extra"]["epoch"] == 0
    assert "bfloat16" not in meta["dtypes"] and "uint8" in meta["dtypes"]
    assert str(jeng.store["vectors"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jeng.store["vectors"]).astype(np.float32),
                                  teng.store["vectors"].float().numpy())
    w = np.asarray(jeng.params["phi_q"][0]["w"])
    np.testing.assert_array_equal(w, teng.model.phi_q[0].weight.detach().numpy().T)
    eng = dataclasses.replace(teng, cfg=dataclasses.replace(teng.cfg, impl="ref"))
    eng.save(path / "ref")
    assert LiraEngine.load(path / "ref", device="cpu").cfg.impl == "ref"
    eng.cfg = dataclasses.replace(teng.cfg, impl="cuda")
    eng.save(path / "cuda")
    assert LiraEngine.load(path / "cuda", device="cpu").cfg.impl == "auto"


def test_save_load_round_trips_a_mutated_store(tmp_path):
    eng, cents, host = raw_engine()
    eng.delete([0, 5, 40])
    eng.insert(cents[2] + host.normal(0, 0.2, (3, 16)).astype(np.float32), [600, 601, 602])
    eng._staleness_counters()[1] = 4                      # drift state to carry
    for step in range(5):                                 # the newest 3 are kept
        eng.save(tmp_path, step=step)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [f"step_{s:010d}"
                                                                for s in (2, 3, 4)]
    back = LiraEngine.load(tmp_path, device="cpu")
    assert back.epoch == eng.epoch == 2
    np.testing.assert_array_equal(back._staleness_counters(), eng._staleness_counters())
    for name in eng.store:
        assert torch.equal(back.store[name], eng.store[name]), name
    a, b = eng.search(cents + 0.01), back.search(cents + 0.01)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    assert b.stats.epoch == 2
    # the JAX engine reads the mutated store, epoch and counters too
    jeng = JaxEngine.load(tmp_path, make_test_mesh())
    assert jeng.epoch == 2 and jeng._staleness_counters()[1] == 4
    np.testing.assert_array_equal(np.asarray(jeng.store["occupancy"]),
                                  eng.store["occupancy"].numpy())


def test_load_jax_reads_epoch_and_staleness_of_a_mutated_jax_save(engines, dataset, tmp_path):
    jeng, _ = engines["eta0"]
    jeng = dataclasses.replace(jeng, store=dict(jeng.store))
    jeng.delete(np.arange(20))
    jeng.save(tmp_path)
    teng = LiraEngine.load_jax(tmp_path, device="cpu")
    assert teng.epoch == jeng.epoch == 1 and teng.cfg.impl == "auto"
    np.testing.assert_array_equal(teng.store["occupancy"].numpy(),
                                  np.asarray(jeng.store["occupancy"]))
    q = dataset.queries[:37]
    assert_same_answer(jeng.search(q, impl="ref"), teng.search(q, impl="ref"), atol_for(teng, q))


# ----------------------------------------------------------------- serve cache

def test_serve_cache_key_normalizes_and_hits(engines, dataset):
    _, teng = engines["eta0"]
    eng = dataclasses.replace(teng)                       # a fresh, empty cache
    assert eng._serve_cache == {}
    q = dataset.queries[:37]
    assert not eng.search(q).stats.cache_hit
    assert eng.search(q[:33]).stats.cache_hit             # same bucket of 64
    assert eng.search(q, impl="auto", tier="exact", k=eng.cfg.k).stats.cache_hit
    assert not eng.search(q[:5]).stats.cache_hit          # bucket 8
    assert not eng.search(q, sigma=0.3).stats.cache_hit
    assert not eng.search(q, k=5).stats.cache_hit
    assert len(eng._serve_cache) == 4
    key = next(iter(eng._serve_cache))
    assert key == (64, eng.sigma, "f32", "ref", eng.cfg.k, eng.cfg.q_cap_factor,
                   eng.cfg.capacity, eng.mesh)


def test_serve_cache_is_an_lru_of_32(engines, dataset):
    _, teng = engines["eta0"]
    eng = dataclasses.replace(teng)
    q = dataset.queries[:8]
    sigmas = [0.1 + 0.01 * i for i in range(40)]
    for s in sigmas:
        eng.search(q, sigma=s)
    assert len(eng._serve_cache) == eng._SERVE_CACHE_MAX == 32
    assert [key[1] for key in eng._serve_cache] == sigmas[-32:]
    assert eng.search(q, sigma=sigmas[8]).stats.cache_hit       # the oldest kept
    assert [key[1] for key in eng._serve_cache][-1] == sigmas[8]  # now the newest
    assert not eng.search(q, sigma=sigmas[7]).stats.cache_hit   # evicted


def test_auto_q_cap_bump_drops_the_serve_cache(engines, dataset):
    _, teng = engines["eta0"]
    eng = dataclasses.replace(teng, cfg=dataclasses.replace(teng.cfg, q_cap_factor=0.1,
                                                            auto_q_cap=True))
    q = dataset.queries[:37]
    assert not eng.search(q, sigma=-1.0).stats.cache_hit
    assert eng.search(q, sigma=-1.0).stats.cache_hit      # the second overflow bumps...
    assert eng.cfg.q_cap_factor == 0.2 and eng._serve_cache == {}
    assert not eng.search(q, sigma=-1.0).stats.cache_hit  # ...so this one misses


# ---------------------------------------------------------- one seed, one index

def test_two_builds_from_one_seed_are_equal(dataset):
    """Probing parameters, the redundancy plan and every store plane, bit
    for bit, on every tier's planes."""
    cfg = BuildConfig(n_partitions=16, k=10, epochs=2, eta=0.03, pq_m=4, pq_ks=32,
                      tier="residual_pq", seed=7)
    a = LiraEngine.build(dataset.base, cfg, device="cpu")
    b = LiraEngine.build(dataset.base, cfg, device="cpu")
    assert a.cfg == b.cfg
    for (na, pa), (nb, pb) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    assert set(a.store) == set(b.store)
    for name in a.store:
        assert torch.equal(a.store[name], b.store[name]), name
    assign = torch.argmin(torch.cdist(torch.from_numpy(dataset.base), a.store["centroids"]), 1)
    plans = [plan_redundancy(e.model, dataset.base, assign, e.store["centroids"], eta=0.03)
             for e in (a, b)]
    for field in plans[0]._fields:
        np.testing.assert_array_equal(getattr(plans[0], field), getattr(plans[1], field))
