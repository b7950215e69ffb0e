"""The serve step over a device mesh, held against the JAX package on the CPU.

JAX engines (``impl="ref"``; a residual_pq build, which also serves f32, and
a pq build, at η ∈ {0, 0.03}) are saved and loaded into the port with
``LiraEngine.load_jax``. The port then serves an odd batch (23 queries,
bucket 24 or 32) over meshes of (data, model) ∈ {(1, 1), (1, 2), (1, 4),
(2, 2)}, every rank on the CPU, and each answer is held against the port
unsharded and the JAX engine unsharded under ``repro_torch.testing``'s rule
(rtol 1e-5, atol 1e-5·max(‖q‖²+‖c‖²)). Over model ranks alone the f32 tier
equals the port unsharded bit for bit and the JAX engine with ids set-equal
per row and distances allclose at rtol = atol = 1e-5; ``nprobe_eff`` and
``overflow`` are equal everywhere, and the sharded ``dedup_hits`` is at most
the unsharded count.

The JAX engine itself also runs sharded, on four forced host devices in a
subprocess: its sharded ``dedup_hits`` and ``overflow`` equal the port's on
the same mesh. Then the residual offsets are taken at each rank's first
partition (``ScanContext.b0``), and a meshed search after inserts and
deletes equals an unsharded one. ``impl="auto"`` resolves for the ranks'
devices, an engine given another mesh makes its steps and placement anew,
and the serve launcher runs on the CPU.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data import make_vector_dataset
from repro.launch.mesh import make_test_mesh as jax_make_test_mesh
from repro.serving.api import BuildConfig as JaxBuildConfig
from repro.serving.engine import LiraEngine as JaxEngine
from repro_torch import testing as rt
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.serving import tiers
from repro_torch.serving.api import SearchRequest
from repro_torch.serving.engine import LiraEngine, batch_mesh_info

MESHES = ((1, 1), (1, 2), (1, 4), (2, 2))
TIERS = ("f32", "pq", "residual_pq")
ETAS = (0.0, 0.03)
NQ = 23
SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module")
def dataset():
    return make_vector_dataset(n=1200, n_queries=NQ, dim=16, n_modes=8, seed=41)


@pytest.fixture(scope="module")
def engines(dataset, tmp_path_factory):
    """(eta, build tier) → (JAX engine, its save directory, port engine)."""
    out = {}
    for eta in ETAS:
        for build in ("residual_pq", "pq"):
            jeng = JaxEngine.build(jax_make_test_mesh(), dataset.base, JaxBuildConfig(
                n_partitions=8, k=10, eta=eta, train_frac=0.4, epochs=2, nprobe_max=8,
                pq_m=4, pq_ks=32, tier=build, impl="ref"))
            path = tmp_path_factory.mktemp(f"{build}{eta}")
            jeng.save(path)
            out[eta, build] = (jeng, path, LiraEngine.load_jax(path, device="cpu"))
    return out


@pytest.fixture(scope="module")
def unsharded(engines, dataset):
    """(eta, tier) → (port unsharded, JAX unsharded) answers, served once."""
    out = {}
    for (eta, build), (jeng, _, teng) in engines.items():
        for tier in (("pq",) if build == "pq" else ("f32", "residual_pq")):
            out[eta, tier] = (teng.search(SearchRequest(queries=dataset.queries, tier=tier)),
                              jeng.search(dataset.queries, tier=tier))
    return out


def meshed(eng, data, model):
    return dataclasses.replace(eng, mesh=make_test_mesh(data, model, device="cpu"))


def atol_for(eng, q):
    return rt.l2_atol(q, eng.store["vectors"], eng.store["ids"])


@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("data, model", MESHES)
def test_meshed_step_matches_port_and_jax(engines, unsharded, dataset, eta, tier, data, model):
    _, _, teng = engines[eta, "pq" if tier == "pq" else "residual_pq"]
    q = dataset.queries
    eng = meshed(teng, data, model)
    got = eng.search(SearchRequest(queries=q, tier=tier))
    solo, ref = unsharded[eta, tier]
    assert got.stats.bucket == eng._batch_bucket(NQ) and got.stats.bucket % data == 0
    atol = atol_for(teng, q)
    for other in (solo, ref):
        np.testing.assert_array_equal(got.nprobe_eff, np.asarray(other.nprobe_eff))
        assert got.overflow == other.overflow
        rt.assert_topk_match(got.dists, got.ids, other.dists, other.ids, atol,
                             what=f"{tier} over ({data}, {model})")
    assert got.stats.dedup_hits <= solo.stats.dedup_hits == ref.stats.dedup_hits
    if model == 1:
        assert got.stats.dedup_hits == solo.stats.dedup_hits
    if data == 1 and tier == "f32":
        # the L2 distance chain does not depend on the block: the same bits
        np.testing.assert_array_equal(got.dists, solo.dists)
        np.testing.assert_array_equal(got.ids, solo.ids)
        np.testing.assert_allclose(got.dists, ref.dists, rtol=1e-5, atol=1e-5)
        for a, b in zip(got.ids, np.asarray(ref.ids)):
            assert set(a.tolist()) == set(b.tolist())


def test_batch_splits_into_equal_rows_of_the_bucket(engines, dataset):
    """Over data ranks each batch row serves its own queries: a half of the
    batch equals an unsharded search of that half alone (the same q_row and
    q_cap), bit for bit."""
    _, _, teng = engines[0.03, "residual_pq"]
    eng = meshed(teng, 2, 2)
    assert batch_mesh_info(eng.mesh) == (("data",), 2)
    assert [eng._batch_bucket(n) for n in (1, 8, 9, 23, 33)] == [8, 8, 16, 32, 64]
    assert meshed(teng, 3, 1)._batch_bucket(9) == 18
    with pytest.raises(ValueError, match="do not split"):
        meshed(teng, 1, 3).search(dataset.queries)     # 8 partitions over 3 ranks
    q = dataset.queries[:16]
    both = eng.search(q, tier="f32")
    for half in (slice(0, 8), slice(8, 16)):
        alone = teng.search(q[half], tier="f32")
        np.testing.assert_array_equal(both.dists[half], alone.dists)
        np.testing.assert_array_equal(both.ids[half], alone.ids)


JAX_SHARDED = r"""
import dataclasses, json, sys
import numpy as np
from repro.launch.mesh import make_test_mesh
from repro.serving.engine import LiraEngine
path, qfile = sys.argv[1], sys.argv[2]
q = np.load(qfile)
out = {}
for tier in ("f32", "residual_pq"):
    for sigma in (0.5, -1.0):
        eng = LiraEngine.load(path, make_test_mesh(model=4))
        eng = dataclasses.replace(eng, cfg=dataclasses.replace(eng.cfg, q_cap_factor=0.5))
        r = eng.search(q, sigma=sigma, tier=tier, impl="ref")
        out[f"{tier} {sigma}"] = [r.stats.dedup_hits, r.overflow,
                                  np.asarray(r.dists).tolist(), np.asarray(r.ids).tolist()]
print(json.dumps(out))
"""


def test_sharded_counts_equal_the_jax_sharded_step(engines, dataset, tmp_path):
    """The JAX engine on a model = 4 mesh of forced host devices (its own
    process): its merge-local ``dedup_hits`` and its ``overflow`` (a q_cap
    small enough to drop probes) equal the port's over the same mesh."""
    _, path, teng = engines[0.03, "residual_pq"]
    qfile = tmp_path / "q.npy"
    np.save(qfile, dataset.queries)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", JAX_SHARDED, str(path), str(qfile)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    eng = meshed(dataclasses.replace(teng, cfg=dataclasses.replace(teng.cfg, q_cap_factor=0.5)),
                 1, 4)
    atol = atol_for(teng, dataset.queries)
    overflowed = 0
    for key, (hits, overflow, dists, ids) in want.items():
        tier, sigma = key.split()
        got = eng.search(dataset.queries, sigma=float(sigma), tier=tier)
        assert (got.stats.dedup_hits, got.overflow) == (hits, overflow), key
        rt.assert_topk_match(got.dists, got.ids, np.asarray(dists, np.float32),
                             np.asarray(ids, np.int32), atol, what=key)
        overflowed += overflow > 0
    assert overflowed  # the small q_cap dropped probes somewhere


def test_residual_offsets_are_taken_at_the_rank_block(engines, dataset, monkeypatch):
    """Rank j of a model axis reads the offsets of partitions [b0, b0 +
    b_loc), not the first block's: the ADC shortlist's operands and
    distances of the two ranks of a model = 2 mesh, stacked, equal the
    unsharded step's. (Stage 2 reranks exactly and a wrong offset is one
    constant a (query, partition), so the answers alone would not show it.)"""
    from repro_torch.kernels import ops as kops

    _, _, teng = engines[0.0, "residual_pq"]
    calls = []
    plain = kops.pq_adc_topk_qbuf

    def record(lut, qbuf, codes, ids, k, **kw):
        out = plain(lut, qbuf, codes, ids, k, **kw)
        calls.append((qbuf, kw["q_off"], kw["cand_off"], out[0]))
        return out

    monkeypatch.setattr(kops, "pq_adc_topk_qbuf", record)
    q = dataset.queries
    teng.search(q, tier="residual_pq")
    meshed(teng, 1, 2).search(q, tier="residual_pq")
    (solo, *ranks) = calls
    assert len(ranks) == 2
    for i, name in enumerate(("qbuf", "q_off", "cand_off", "ADC distances")):
        torch.testing.assert_close(torch.cat([r[i] for r in ranks]), solo[i], rtol=0, atol=0,
                                   msg=name)
    assert tiers.resolve("residual_pq").store_pspecs() == {
        "centroids": None, "vectors": "model", "ids": "model", "occupancy": "model",
        "codes": "model", "codebooks": None, "cterm": "model"}


def test_meshed_search_after_mutations_equals_unsharded(engines, dataset):
    """Inserts and deletes through a meshed engine move its epoch, which
    places the ranks' operands again; its answers equal an unsharded engine
    over the same store, before and after an insert grows the capacity."""
    _, path, _ = engines[0.03, "residual_pq"]
    eng = meshed(LiraEngine.load_jax(path, device="cpu"), 1, 4)
    q = dataset.queries
    first = eng.search(q)
    ranks = eng.rank_operands()
    assert eng.rank_operands() is ranks  # placed once an epoch
    dead = np.asarray(first.ids[:4, :3]).reshape(-1)
    eng.delete(dead)
    eng.insert(q[:6] + np.random.default_rng(3).normal(0, 0.01, (6, 16)).astype(np.float32),
               np.arange(6) + 10_000)
    assert eng.rank_operands() is not ranks
    rng = np.random.default_rng(4)
    for step in ("mutated", "grown"):
        solo = meshed(eng, 1, 1)
        for tier in ("f32", "residual_pq"):
            a, b = eng.search(q, tier=tier), solo.search(q, tier=tier)
            rt.assert_topk_match(a.dists, a.ids, b.dists, b.ids, atol_for(solo, q),
                                 what=f"{step} {tier}")
            if tier == "f32":
                np.testing.assert_array_equal(a.dists, b.dists)
            assert not np.isin(a.ids, dead).any()
            assert np.isin(np.arange(6) + 10_000, a.ids).any()
        if step == "mutated":
            cap = eng.cfg.capacity
            hot = (q[:1] + rng.normal(0, 0.01, (4 * cap, 16))).astype(np.float32)
            eng.insert(hot, np.arange(4 * cap) + 20_000)
            assert eng.cfg.capacity > cap


def test_mesh_places_ranks_round_robin():
    mesh = make_test_mesh(2, 3, devices=["cpu"])
    assert mesh.shape == {"data": 2, "model": 3} and len(mesh.devices) == 6
    assert mesh.unique_devices() == (torch.device("cpu"),)
    pod = make_test_mesh(1, 2, pod=2, device="cpu")
    assert pod.axis_names == ("pod", "data", "model") and len(pod.devices) == 4
    with pytest.raises(TypeError, match="not both"):
        make_test_mesh(device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="devices for"):
        type(mesh)(("data", "model"), (2, 2), mesh.devices[:3])


def test_auto_impl_resolves_for_the_ranks_devices(engines, dataset):
    """``"auto"`` names the backend of the devices the kernels run on, the
    ranks', not the store's: a store on the CPU served by ranks on a card
    resolves to ``"cuda"`` in the engine, its front-end's key and a cluster
    over it, and ranks on the CPU to ``"ref"``. Resolving places nothing, so
    the card's mesh is only named here."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving.cluster import LiraCluster
    from repro_torch.serving.frontend import ServingFrontend

    _, _, teng = engines[0.0, "residual_pq"]
    host = dataclasses.replace(teng, cfg=dataclasses.replace(teng.cfg, impl="auto"))
    card = dataclasses.replace(host, mesh=Mesh(("data", "model"), (1, 2),
                                               (torch.device("cuda", 0),) * 2))
    req = SearchRequest(queries=dataset.queries[0])
    for eng, want in ((host, "ref"), (card, "cuda")):
        assert eng.resolve_impl() == eng.resolve_impl("auto") == want
        assert eng.resolve_impl("ref") == "ref" and eng.resolve_impl("cuda") == "cuda"
        assert ServingFrontend(eng)._resolve_key(req)[3] == want
        cl = LiraCluster([eng], [np.arange(len(dataset.base))])
        assert cl.resolve_impl() == cl._resolve(req)[3] == want
    with pytest.raises(ValueError, match="unknown impl"):
        card.resolve_impl("triton")


def test_a_new_mesh_gets_its_own_steps_and_placement(engines, dataset):
    """The serve cache and the ranks' placement are keyed by the mesh, so
    an engine given another mesh makes steps and blocks for it (a step is
    made for one q_row and b_loc) and answers as before."""
    _, _, teng = engines[0.03, "residual_pq"]
    eng = meshed(teng, 1, 4)
    q = dataset.queries
    first = eng.search(q, tier="f32")
    assert eng.search(q, tier="f32").stats.cache_hit
    assert len(eng.rank_operands()[0]) == 4
    eng.mesh = make_test_mesh(2, 2, device="cpu")
    again = eng.search(q, tier="f32")
    assert not again.stats.cache_hit
    assert [len(row) for row in eng.rank_operands()] == [2, 2]
    rt.assert_topk_match(again.dists, again.ids, first.dists, first.ids, atol_for(teng, q))
    np.testing.assert_array_equal(again.nprobe_eff, first.nprobe_eff)


def test_serve_launcher_runs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` at a small size:
    the meshed engine (one data rank by two model ranks), the front-end
    stream and the cluster with a replica killed mid-stream, whose
    in-flight batch replays."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--n", "3000", "--queries", "256", "--partitions", "16"])
    out = capsys.readouterr().out
    assert "building index on cpu (mesh {'data': 1, 'model': 2})" in out
    assert "dropped probes (q_cap overflow)=" in out and "search_one: k=10" in out
    assert "1024 rows over 32 batches" in out and "1 re-queued" in out and "0 lost" in out
