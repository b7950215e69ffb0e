"""The port's quantized tiers against the JAX reference, on the CPU, from the
same numpy inputs.

* ``core/pq.py``: Lloyd per subspace from the reference's k-means++ picks,
  ``encode`` (codes equal except where two codewords tie within rtol 1e-5),
  ``decode``, ``adc_lut``, ``residual_cross_terms`` and
  ``residual_query_offsets`` (rtol 1e-5, atol 1e-5·the largest magnitude of
  the quantity), and the residual ADC identity against exact L2 to the
  reconstruction (atol 2e-5·the largest distance, as tests/test_residual_pq.py).
* Serve parity: JAX engines built with ``tier="pq"``, ``tier="residual_pq"``
  (η 0.03), ``residual_pq`` over a bfloat16 store and ``pq`` with uint16
  codes (ks 512) are saved, loaded with ``load_jax(device="cpu")`` and
  searched with ``impl="ref"`` on both sides at an odd batch of 37 across
  σ ∈ {0.3, 0.5, 0.9}: distances and ids under ``repro_torch.testing``'s rule
  (rtol 1e-5, atol 1e-5·max(‖q‖²+‖c‖²); ids set-equal per row except among
  ties within that tolerance at the k-th place), ``nprobe_eff``, ``overflow``
  and ``dedup_hits`` equal.
* Tier checks: ``tier="f32"`` on a residual store gives the f32 answer, and
  ``tier="pq"`` on residual codes raises ``ValueError``, as in the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import pq as jpq
from repro.data import make_vector_dataset
from repro.launch.mesh import make_test_mesh
from repro.serving.api import BuildConfig as JaxBuildConfig
from repro.serving.engine import LiraEngine as JaxEngine
from repro.serving.quantized import scan_store_bytes as jax_scan_store_bytes
from repro_torch import testing as rt
from repro_torch.configs import lira_ann, lira_ann_q
from repro_torch.core import ground_truth as tgt
from repro_torch.core import pq as tpq
from repro_torch.core.metrics import recall_at_k
from repro_torch.serving import quantized, tiers
from repro_torch.serving.api import BuildConfig
from repro_torch.serving.engine import LiraEngine

RTOL = 1e-5

ENGINES = {"pq": dict(tier="pq", eta=0.0),
           "residual_pq": dict(tier="residual_pq", eta=0.03),
           "residual_pq-bf16": dict(tier="residual_pq", eta=0.03, store_dtype="bfloat16"),
           "pq-uint16": dict(tier="pq", eta=0.03, pq_m=2, pq_ks=512)}


def close(a, b, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5 * max(1.0, float(np.abs(b).max())),
                               err_msg=what)


# ------------------------------------------------------------------ core/pq

@pytest.fixture(scope="module")
def pq_data():
    """Residuals of clustered points, JAX codebooks trained on them, and the
    reference's k-means++ picks those codebooks started from."""
    rng = np.random.default_rng(0)
    n, d, b, m, ks = 600, 16, 6, 4, 32
    cents = rng.normal(0, 3, (b, d)).astype(np.float32)
    assign = rng.integers(0, b, n).astype(np.int32)
    x = cents[assign] + rng.normal(0, 0.5, (n, d)).astype(np.float32)
    res = x - cents[assign]
    key = jax.random.PRNGKey(3)
    jbook = jpq.train_pq(key, res, m=m, ks=ks, n_iters=6)
    xs = jnp.asarray(res).reshape(n, m, d // m)
    init = np.stack([np.asarray(jkm.plus_plus_init(r, xs[:, j], ks))
                     for j, r in enumerate(jax.random.split(key, m))])
    q = rng.normal(0, 3, (9, d)).astype(np.float32)
    return dict(x=x, res=res, cents=cents, assign=assign, m=m, ks=ks, jbook=jbook,
                init=init, q=q)


def torch_book(jbook):
    return tpq.PQCodebook(codebooks=torch.from_numpy(np.array(jbook.codebooks)),
                          m=jbook.m, ks=jbook.ks)


def test_code_dtype_follows_ks():
    assert tpq.code_dtype(16) == tpq.code_dtype(256) == torch.uint8
    assert tpq.code_dtype(257) == tpq.code_dtype(65536) == torch.uint16
    assert tpq.code_dtype(65537) == torch.int32
    for ks in (256, 512, 70000):
        assert torch.empty(0, dtype=tpq.code_dtype(ks)).numpy().dtype == jpq.code_dtype(ks)


def test_train_pq_from_the_reference_picks_matches(pq_data):
    d = pq_data
    book = tpq.train_pq(torch.from_numpy(d["res"]), m=d["m"], ks=d["ks"], n_iters=6,
                        init=torch.from_numpy(d["init"]))
    assert book.codebooks.shape == (d["m"], d["ks"], 4) and book.ks == d["ks"]
    close(book.codebooks.numpy(), d["jbook"].codebooks, "codebooks")
    with pytest.raises(ValueError, match="not divisible"):
        tpq.train_pq(torch.zeros((8, 10)), m=4, ks=2, generator=torch.Generator())


def test_train_pq_from_a_generator_is_seeded():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(200, 8)).astype(np.float32))
    a, b = (tpq.train_pq(x, m=2, ks=8, n_iters=3, generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    assert torch.equal(a.codebooks, b.codebooks)


@pytest.mark.parametrize("batch", [64, 8192])
def test_encode_matches_except_at_ties(pq_data, batch):
    d = pq_data
    book = torch_book(d["jbook"])
    codes = tpq.encode(book, torch.from_numpy(d["res"]), batch=batch)
    jcodes = jpq.encode(d["jbook"], d["res"])
    assert codes.dtype == torch.uint8 and codes.shape == jcodes.shape
    diff = codes.numpy() != jcodes
    if diff.any():  # only where the two codewords tie within the tolerance
        sub = d["res"].reshape(len(d["res"]), d["m"], -1)
        cb = np.asarray(d["jbook"].codebooks)
        n_i, m_i = np.nonzero(diff)
        da = ((sub[n_i, m_i] - cb[m_i, codes.numpy()[n_i, m_i]]) ** 2).sum(-1)
        db = ((sub[n_i, m_i] - cb[m_i, jcodes[n_i, m_i]]) ** 2).sum(-1)
        np.testing.assert_allclose(da, db, rtol=RTOL, atol=1e-5)


def test_decode_lut_and_residual_terms_match(pq_data):
    d = pq_data
    book = torch_book(d["jbook"])
    codes = jpq.encode(d["jbook"], d["res"])
    tcodes = torch.from_numpy(codes)
    close(tpq.decode(book, tcodes, batch=100).numpy(), jpq.decode(d["jbook"], codes), "decode")
    q = torch.from_numpy(d["q"])
    close(tpq.adc_lut(book, q).numpy(), jpq.adc_lut(d["jbook"], jnp.asarray(d["q"])), "adc_lut")
    close(tpq.adc_distances(book, q, tcodes).numpy(),
          jpq.adc_distances(d["jbook"], jnp.asarray(d["q"]), jnp.asarray(codes)), "adc")
    rows = d["cents"][d["assign"]]
    close(tpq.residual_cross_terms(book, torch.from_numpy(rows), tcodes, batch=128).numpy(),
          jpq.residual_cross_terms(d["jbook"], rows, codes), "cross terms")
    close(tpq.residual_query_offsets(torch.from_numpy(d["cents"]), q).numpy(),
          jpq.residual_query_offsets(jnp.asarray(d["cents"]), jnp.asarray(d["q"])), "offsets")


def test_residual_adc_equals_exact_l2_to_reconstruction(pq_data):
    """Shared-LUT ADC + query offset + cross term = ‖q − (c_b + r̂)‖²."""
    d = pq_data
    book = tpq.train_pq(torch.from_numpy(d["res"]), m=d["m"], ks=d["ks"], n_iters=5,
                        generator=torch.Generator().manual_seed(0))
    codes = tpq.encode(book, torch.from_numpy(d["res"]))
    cents, assign = torch.from_numpy(d["cents"]), torch.from_numpy(d["assign"]).long()
    recon = cents[assign] + tpq.decode(book, codes)
    q = torch.from_numpy(d["q"])
    got = (tpq.adc_distances(book, q, codes)
           + tpq.residual_query_offsets(cents, q)[:, assign]
           + tpq.residual_cross_terms(book, cents[assign], codes)[None, :])
    want = ((q[:, None] - recon[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=2e-5 * max(1.0, float(want.abs().max())))


def test_quantized_store_clamps_ks_and_masks_nothing():
    rng = np.random.default_rng(2)
    vec = torch.from_numpy(rng.normal(size=(3, 10, 8)).astype(np.float32))
    ids = torch.full((3, 10), -1, dtype=torch.int32)
    ids[:, :4] = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    qs = quantized.build_quantized_store(vec, ids, m=2, ks=64, residual=True,
                                         centroids=vec.mean(1),
                                         generator=torch.Generator().manual_seed(0))
    assert qs.ks == 6 and qs.codes.shape == (3, 10, 2) and qs.cterm.shape == (3, 10)
    assert qs.codes.dtype == torch.uint8 and int(qs.codes.max()) < 6
    with pytest.raises(ValueError, match="centroids"):
        quantized.build_quantized_store(vec, ids, m=2, residual=True)


def test_configs_are_the_reference_values():
    from repro.configs import lira_ann as jcfg
    from repro.configs import lira_ann_q as jcfg_q

    for ours, theirs in ((lira_ann.CONFIG_QUANTIZED, jcfg.CONFIG_QUANTIZED),
                         (lira_ann.SMOKE_QUANTIZED, jcfg.SMOKE_QUANTIZED),
                         (lira_ann_q.CONFIG, jcfg_q.CONFIG), (lira_ann_q.SMOKE, jcfg_q.SMOKE)):
        for f in ("arch", "dim", "n_partitions", "capacity", "k", "nprobe_max", "tier",
                  "pq_m", "pq_ks", "rerank"):
            assert getattr(ours, f) == getattr(theirs, f), f


# ------------------------------------------------------------ serve parity

@pytest.fixture(scope="module")
def dataset():
    return make_vector_dataset(n=3000, n_queries=64, dim=16, n_modes=12, seed=5)


@pytest.fixture(scope="module")
def engines(dataset, tmp_path_factory):
    """One JAX build per quantized engine kind, saved and loaded into the port."""
    out = {}
    for name, kw in ENGINES.items():
        kw = {"pq_m": 4, "pq_ks": 32, "rerank": 2, **kw}
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


@pytest.mark.parametrize("kind", list(ENGINES))
def test_load_jax_carries_the_quantized_store(engines, kind):
    jeng, teng = engines[kind]
    assert teng.cfg.tier == jeng.cfg.tier and teng.cfg.pq_ks == jeng.cfg.pq_ks
    assert set(teng.store) == set(jeng.store)
    assert teng.store["codes"].dtype == (torch.uint16 if jeng.cfg.pq_ks > 256 else torch.uint8)
    for name in ("codes", "codebooks", "cterm"):
        if name in jeng.store:
            np.testing.assert_array_equal(teng.store[name].numpy(), np.asarray(jeng.store[name]))
    assert quantized.scan_store_bytes(teng.store) == {
        key: (val if key == "ratio" else int(val))
        for key, val in jax_scan_store_bytes(jeng.store).items()}


@pytest.mark.parametrize("sigma", [0.3, 0.5, 0.9])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_search_matches_jax(engines, dataset, kind, sigma):
    jeng, teng = engines[kind]
    q = dataset.queries[:37]
    jr = jeng.search(q, sigma=sigma, impl="ref")
    tr = teng.search(q, sigma=sigma, impl="ref")
    assert tr.stats.bucket == jr.stats.bucket == 64 and tr.stats.tier == jeng.cfg.tier
    assert_same_answer(jr, tr, rt.l2_atol(q, teng.store["vectors"], teng.store["ids"]))


def test_f32_tier_on_a_residual_store_is_the_f32_answer(engines, dataset):
    jeng, teng = engines["residual_pq"]
    q = dataset.queries[:37]
    jr = jeng.search(q, tier="f32", impl="ref")
    tr = teng.search(q, tier="f32", impl="ref")
    assert tr.stats.tier == "f32"
    assert_same_answer(jr, tr, rt.l2_atol(q, teng.store["vectors"], teng.store["ids"]))


def test_pq_tier_refuses_residual_codes(engines, dataset):
    jeng, teng = engines["residual_pq"]
    q = dataset.queries[:5]
    with pytest.raises(ValueError, match="residual-encoded"):
        jeng.search(q, tier="pq", impl="ref")
    with pytest.raises(ValueError, match="residual-encoded"):
        teng.search(q, tier="pq")
    _, f32 = engines["pq"]
    with pytest.raises(ValueError, match="lacks"):
        LiraEngine(cfg=f32.cfg, model=f32.model, device=f32.device,
                   store={k: v for k, v in f32.store.items() if k in tiers.BASE_FIELDS}
                   ).search(q)


def test_tier_registry_and_slot_fields():
    assert tiers.resolve("quantized").name == "pq" and tiers.resolve("residual").name == "residual_pq"
    cfg = lira_ann.SMOKE_QUANTIZED
    assert tiers.resolve("residual_pq").slot_fields(cfg) == (
        "vectors", "ids", "occupancy", "codes", "cterm")
    assert tiers.resolve("pq").store_specs(cfg)["codebooks"] == ((2, 16, 8), torch.float32)
    with pytest.raises(ValueError, match="unknown serving tier"):
        tiers.resolve("int4")


@pytest.mark.parametrize("tier", ["pq", "residual_pq"])
def test_build_on_the_cpu_serves_near_the_f32_tier(dataset, tier):
    """The port's own build (k-means, probing, PQ training on torch
    Generators): the quantized answer's recall@10 is within 0.05 of the f32
    tier's on the same engine, pq_m resolves and ks is clamped into cfg."""
    eng = LiraEngine.build(dataset.base, BuildConfig(n_partitions=16, k=10, epochs=2,
                                                     tier=tier, pq_ks=64, rerank=4),
                           device="cpu")
    assert eng.cfg.tier == tier and eng.cfg.pq_m == 16 and eng.cfg.pq_ks == 64
    q = dataset.queries
    _, gti = tgt.exact_knn(q, dataset.base, 10, device="cpu")
    rq = recall_at_k(eng.search(q, sigma=0.3).ids, gti, 10)
    rf = recall_at_k(eng.search(q, sigma=0.3, tier="f32").ids, gti, 10)
    assert rq >= rf - 0.05, (rq, rf)
    f32 = LiraEngine.build(dataset.base[:500], BuildConfig(n_partitions=4, k=5, epochs=1),
                           device="cpu")
    assert f32.cfg.pq_m == 16 and "codes" not in f32.store


@pytest.mark.parametrize("chunk", [None, 1])
def test_full_shortlist_equals_the_f32_scan(chunk, monkeypatch):
    """With rk = capacity the rerank sees every valid slot, so the quantized
    scan returns the f32 scan's answer for the occupied slots, k > capacity
    included (inf / -1 tail); a rerank chunk of one (bucket, slot) pair
    changes nothing."""
    from repro_torch import testing as rtest
    from repro_torch.serving import scan

    if chunk is not None:
        monkeypatch.setattr(scan, "_RERANK_CHUNK", chunk)
    rng = np.random.default_rng(7)
    b, cap, d, n_rows, q_cap, k = 5, 9, 8, 11, 6, 12
    vecs = torch.from_numpy(rng.normal(size=(b, cap, d)).astype(np.float32))
    ids = torch.from_numpy(rng.permutation(b * cap).reshape(b, cap).astype(np.int32))
    ids[rng.random((b, cap)) < 0.2] = -1
    q = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(np.float32))
    q_pad = torch.cat([q, torch.full((1, d), 1e9)])
    qbuf = torch.from_numpy(rng.integers(0, n_rows + 1, (b, q_cap)).astype(np.int32))
    book = tpq.train_pq(vecs.reshape(-1, d), m=2, ks=4, n_iters=3,
                        generator=torch.Generator().manual_seed(1))
    codes = tpq.encode(book, vecs.reshape(-1, d)).reshape(b, cap, 2)
    lut_pad = torch.cat([tpq.adc_lut(book, q), torch.zeros((1, 2, 4))])
    qd, qi = scan.run("ref", qbuf, q_pad, vecs, ids, k, lut_pad=lut_pad, codes_loc=codes,
                      rk=cap)
    fd, fi = scan.run("ref", qbuf, q_pad, vecs, ids, k)
    occ = rtest.occupied(q_pad, qbuf)
    assert bool(torch.isinf(qd[~occ]).all()) and bool((qi[~occ] == -1).all())
    rtest.assert_topk_match(qd[occ], qi[occ], fd[occ], fi[occ],
                            rtest.l2_atol(q, vecs, ids))
