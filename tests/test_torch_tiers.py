"""The serving-tier registry's extension point (``repro_torch.serving.tiers``)
against the reference's ``tests/test_tiers.py``.

Twins of its registry and unknown-tier tests and of its acceptance gate: a
bfloat16 toy tier registered outside the package (here) builds and serves
through the unchanged ``LiraEngine`` (the legacy booleans of the reference's
config are not ported, so their assertion has no twin). Beyond the
reference: the same toy-tier store served by the JAX engine (its own toy
tier registered) and by the port (``load_jax``), ids and distances held
under the parity contract of ``repro_torch.testing``; a save / load round
trip and the serve cache through a tier registered at run time; and no
tier name spelled on the serve path outside ``serving/tiers.py``.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ground_truth as gt
from repro.core.metrics import recall_at_k
from repro.data import make_vector_dataset
from repro.launch.mesh import make_test_mesh
from repro.models.api import sds as jax_sds
from repro.serving import BuildConfig as JaxBuildConfig
from repro.serving import LiraEngine as JaxEngine
from repro.serving import tiers as jax_tiers
from repro_torch import testing as rt
from repro_torch.serving import tiers
from repro_torch.serving.api import BuildConfig, SearchRequest
from repro_torch.serving.engine import LiraEngine

SERVE_PATH = ("engine.py", "scan.py", "cluster.py", "frontend.py", "mutable.py")
BUILD = dict(n_partitions=8, k=10, eta=0.03, train_frac=0.4, epochs=2, nprobe_max=8)


@pytest.fixture(scope="module")
def dataset():
    return make_vector_dataset(n=2000, n_queries=32, dim=16, n_modes=8, seed=17)


@pytest.fixture(scope="module")
def gti(dataset):
    _, i = gt.exact_knn(dataset.queries, dataset.base, 10)
    return np.asarray(i)


class _Bf16ToyTier(tiers.F32Tier):
    """The f32 scan over a bfloat16 vector plane, declared through the
    registry interface alone."""

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


class _JaxBf16ToyTier(jax_tiers.F32Tier):
    """The reference test's toy tier."""

    name = "bf16_toy"
    aliases = ()

    def store_specs(self, cfg):
        specs = super().store_specs(cfg)
        specs["vectors"] = jax_sds(specs["vectors"].shape, jnp.bfloat16)
        return specs

    def build_store(self, rng, cfg, store_h):
        store, cfg = super().build_store(rng, cfg, store_h)
        store["vectors"] = store["vectors"].astype(jnp.bfloat16)
        return store, cfg


@pytest.fixture()
def toy_tier():
    tiers.register(_Bf16ToyTier)
    yield
    tiers._REGISTRY.pop("bf16_toy", None)


@pytest.fixture()
def jax_toy_tier():
    jax_tiers.register(_JaxBf16ToyTier)
    yield
    jax_tiers._REGISTRY.pop("bf16_toy", None)


# ------------------------------------------------------------ registry

def test_registry_resolves_names_and_aliases():
    assert tiers.resolve("f32").name == "f32"
    assert tiers.resolve("quantized").name == "pq"
    assert tiers.resolve("residual").name == "residual_pq"
    t = tiers.resolve("pq")
    assert tiers.resolve(t) is t  # already-resolved passthrough
    assert set(tiers.names()) >= {"f32", "pq", "residual_pq"}
    assert tiers.names() == tuple(sorted(jax_tiers.names()))
    assert all(isinstance(tiers.resolve(n), tiers.Tier) for n in tiers.names())


def test_register_indexes_aliases_and_later_registrations_win(toy_tier):
    assert "bf16_toy" in tiers.names()
    first = tiers.resolve("bf16_toy")

    @tiers.register
    class _Again(_Bf16ToyTier):
        aliases = ("toy",)

    assert tiers.resolve("bf16_toy") is tiers.resolve("toy") is not first
    assert isinstance(tiers.resolve("toy"), _Again)
    tiers._REGISTRY.pop("toy")
    assert tiers.names().count("bf16_toy") == 1


def test_unknown_tier_fails_fast():
    with pytest.raises(ValueError, match="unknown serving tier"):
        tiers.resolve("int4")
    with pytest.raises(ValueError, match="registered tiers: "):
        tiers.resolve("int4")
    eng = LiraEngine.build(make_vector_dataset(n=600, n_queries=4, dim=16, seed=3).base,
                           BuildConfig(n_partitions=4, k=5, epochs=1, nprobe_max=4),
                           device="cpu")
    with pytest.raises(ValueError, match="unknown serving tier"):
        eng.search(SearchRequest(queries=np.zeros((4, 16), np.float32), tier="int4"))


def test_serve_path_never_names_a_tier():
    """The engine, scan, cluster, front-end and mutable index branch on no
    tier: no "pq" / "residual_pq" literal outside serving/tiers.py."""
    root = pathlib.Path(tiers.__file__).parent
    for name in SERVE_PATH:
        text = (root / name).read_text()
        assert not re.search(r"""["'](residual_)?pq["']""", text), name


# ------------------------------------------- extensibility (acceptance gate)

def test_toy_tier_serves_without_engine_edits(dataset, gti, toy_tier):
    """Registering a tier is enough to build and serve through it: the
    engine never branches on it."""
    eng = LiraEngine.build(dataset.base, BuildConfig(tier="bf16_toy", **BUILD), device="cpu")
    assert eng.cfg.tier == "bf16_toy"
    assert eng.store["vectors"].dtype == torch.bfloat16
    res = eng.search(SearchRequest(queries=dataset.queries, sigma=-1.0))
    assert res.stats.tier == "bf16_toy"
    assert recall_at_k(res.ids, gti, 10) >= 0.95  # bf16 rounding only


def test_toy_tier_save_load_and_serve_cache(dataset, toy_tier, tmp_path):
    """save / load and the serve cache's key resolve a tier registered at
    run time: the loaded engine's plane is bf16 again and serves the same
    answer, a second call hits the cache."""
    eng = LiraEngine.build(dataset.base, BuildConfig(tier="bf16_toy", **BUILD), device="cpu")
    eng.save(tmp_path / "toy")
    loaded = LiraEngine.load(tmp_path / "toy", device="cpu")
    assert loaded.cfg == eng.cfg and loaded.store["vectors"].dtype == torch.bfloat16
    want = eng.search(dataset.queries)
    got = loaded.search(dataset.queries)
    np.testing.assert_array_equal(want.dists, got.dists)
    np.testing.assert_array_equal(want.ids, got.ids)
    again = loaded.search(dataset.queries)
    assert again.stats.cache_hit and again.stats.tier == "bf16_toy"


def test_toy_tier_matches_jax(dataset, toy_tier, jax_toy_tier, tmp_path):
    """The JAX engine built with the reference's toy tier, saved, and loaded
    by the port with its own: both serve the same queries under the parity
    contract (rtol 1e-5, ids set-equal but for ties at the k-th place)."""
    jeng = JaxEngine.build(make_test_mesh(), dataset.base,
                           JaxBuildConfig(tier="bf16_toy", impl="ref", **BUILD))
    jeng.save(tmp_path / "jax")
    teng = LiraEngine.load_jax(tmp_path / "jax", device="cpu")
    assert teng.cfg.tier == "bf16_toy" and teng.store["vectors"].dtype == torch.bfloat16
    for sigma in (-1.0, 0.5):
        jr = jeng.search(dataset.queries, sigma=sigma, impl="ref")
        tr = teng.search(dataset.queries, sigma=sigma, impl="ref")
        assert tr.stats.tier == "bf16_toy"
        np.testing.assert_array_equal(tr.nprobe_eff, np.asarray(jr.nprobe_eff))
        q = torch.as_tensor(dataset.queries).to(torch.bfloat16).float()
        cn = (teng.store["vectors"].float() ** 2).sum(-1).max()
        rt.assert_topk_match(tr.dists, tr.ids, jr.dists, jr.ids,
                             1e-5 * float((q * q).sum(-1).max() + cn))
