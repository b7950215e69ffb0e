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
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import make_vector_dataset
from repro.launch.mesh import make_test_mesh
from repro.serving.api import BuildConfig as JaxBuildConfig
from repro.serving.engine import LiraEngine as JaxEngine
from repro_torch import testing as rt
from repro_torch.kernels import ops as kops
from repro_torch.serving.api import SearchRequest
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
