"""The port's mutable index against the JAX reference, on the CPU.

* ``serving/mutable.py``: each function equal to ``repro.serving.mutable``'s
  on the same numpy inputs (placement, growth, packing, compaction, layout).
* Step by step: a JAX engine is built and saved, the port loads it with
  ``load_jax``, and both run the same delete / insert / growing insert /
  delete / compact / ``maybe_repartition(force=True)`` sequence. After each step the
  ``ids`` and ``occupancy`` planes and the vectors are equal; the codes equal
  except at counted near-ties (a sub-vector within 1e-5 of equidistant from
  two codewords); ``cterm`` within ``testing.adc_atol`` where the codes
  agree; ``epoch``, ``capacity`` and ``staleness()`` equal; and a search
  agrees under ``tests/test_torch_engine.py``'s parity contract (distances
  rtol 1e-5, atol 1e-5·max(‖q‖²+‖c‖²); ids up to ties at the k-th place;
  ``nprobe_eff``, ``overflow`` and ``dedup_hits`` equal).
* The port's own properties, as the reference's ``tests/test_mutable.py``:
  a tombstoned store serves the bits of its compacted rebuild on every tier;
  sustained churn keeps recall@10 within 0.02 of a fresh rebuild; residual
  ``encode_rows`` reproduces the build's codes and cross terms; same-shape
  mutations write in place (``data_ptr()`` unchanged) and keep the serve
  cache hitting; growth is a shape epoch that drops it; deleting unknown ids
  is a no-op; staleness gates the repartition.
"""
import numpy as np
import pytest
import torch

from _torch_engines import raw_engine
from repro.data import make_vector_dataset as jax_make_vector_dataset
from repro.launch.mesh import make_test_mesh
from repro.serving import mutable as jmutable
from repro.serving.api import BuildConfig as JaxBuildConfig
from repro.serving.engine import LiraEngine as JaxEngine
from repro_torch import testing as rt
from repro_torch.core import ground_truth as gt
from repro_torch.core.metrics import recall_at_k
from repro_torch.data.synthetic import make_vector_dataset
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import mutable, tiers
from repro_torch.serving.api import BuildConfig, SearchRequest
from repro_torch.serving.engine import LiraEngine

TIERS = ["f32", "pq", "residual_pq"]


def as_np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------- planning vs the reference

@pytest.mark.parametrize("window", [1, 2, 4, 8])
def test_plan_insert_matches_reference(window):
    rng = np.random.default_rng(window)
    occ = rng.random((12, 10)) < 0.8
    dist = rng.random((60, 12)).astype(np.float32)
    want = jmutable.plan_insert(occ, dist, window=window)
    got = mutable.plan_insert(occ, torch.from_numpy(dist), window=window)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (~got.ok).any() and got.ok.any()
    assert got.misassigned.any() == (window > 1)


def test_plan_insert_prefers_nearest_free_slot_and_reports_failures():
    occ = np.array([[True, True], [True, False], [False, False]])
    dist = np.array([[0.0, 1.0, 2.0], [5.0, 0.0, 1.0]], np.float32)
    plan = mutable.plan_insert(occ, dist)
    assert plan.parts.tolist() == [1, 2] and plan.slots.tolist() == [1, 0]
    assert plan.misassigned.tolist() == [True, True] and plan.ok.all()
    assert not occ[1, 1]  # input occupancy not modified
    plan = mutable.plan_insert(np.array([[True], [True], [False]]),
                               np.array([[0.0, 1.0, 2.0]], np.float32), window=2)
    assert not plan.ok.any() and plan.parts.tolist() == [-1]


def _planes(rng, b=3, cap=5):
    return {"vectors": rng.normal(size=(b, cap, 4)).astype(np.float32),
            "ids": rng.integers(-1, 50, (b, cap)).astype(np.int32),
            "occupancy": rng.random((b, cap)) < 0.5,
            "codes": rng.integers(0, 255, (b, cap, 2)).astype(np.uint8),
            "cterm": rng.normal(size=(b, cap)).astype(np.float32)}


def test_grow_store_matches_reference():
    planes = _planes(np.random.default_rng(0))
    want = jmutable.grow_store(planes, 8)
    got = mutable.grow_store({n: torch.from_numpy(a) for n, a in planes.items()}, 8)
    for name in planes:
        np.testing.assert_array_equal(as_np(got[name]), want[name], err_msg=name)
        assert got[name].dtype == torch.from_numpy(want[name]).dtype
    assert (as_np(got["vectors"])[:, 5:] == 1e6).all() and (as_np(got["ids"])[:, 5:] == -1).all()
    with pytest.raises(ValueError, match="cannot shrink"):
        mutable.grow_store(planes, 2)
    assert mutable.PLACE_WINDOW == jmutable.PLACE_WINDOW
    for name in ("vectors", "ids", "occupancy", "codes", "cterm"):
        assert mutable.fill_value(name) == jmutable.fill_value(name)


@pytest.mark.parametrize("min_capacity", [1, 4, 9])
def test_pack_order_and_compact_store_match_reference(min_capacity):
    rng = np.random.default_rng(min_capacity)
    planes = _planes(rng, b=4, cap=7)
    occ = planes["occupancy"]
    perm_w, live_w = jmutable.pack_order(occ)
    perm, live = mutable.pack_order(torch.from_numpy(occ))
    np.testing.assert_array_equal(as_np(perm), perm_w)
    np.testing.assert_array_equal(as_np(live), live_w)
    want, cap_w = jmutable.compact_store(planes, occ, min_capacity=min_capacity)
    got, cap = mutable.compact_store({n: torch.from_numpy(a) for n, a in planes.items()},
                                     torch.from_numpy(occ), min_capacity=min_capacity)
    assert cap == cap_w
    for name in planes:
        np.testing.assert_array_equal(as_np(got[name]), want[name], err_msg=name)


def test_layout_rows_matches_reference():
    assign = np.random.default_rng(3).integers(0, 6, 200)
    slots_w, counts_w = jmutable.layout_rows(assign, 7)
    slots, counts = mutable.layout_rows(torch.from_numpy(assign), 7)
    np.testing.assert_array_equal(as_np(slots), slots_w)
    np.testing.assert_array_equal(as_np(counts), counts_w)


# ------------------------------------------- step by step against the JAX engine

SEQ_STEPS = ["delete", "insert", "grow", "delete hot", "compact", "repartition"]


def _assert_codes_match(tc, jc, x_res, codebooks, what):
    """Codes equal except where the sub-vector is within 1e-5 of equidistant
    from the two codewords (a near-tie); returns the number of near-ties."""
    diff = np.argwhere(tc != jc)
    if not len(diff):
        return 0
    m = codebooks.shape[0]
    d_sub = codebooks.shape[2]
    for r, j in diff:
        sub = x_res[r, j * d_sub:(j + 1) * d_sub].astype(np.float64)
        da = ((sub - codebooks[j, tc[r, j]]) ** 2).sum()
        db = ((sub - codebooks[j, jc[r, j]]) ** 2).sum()
        scale = (sub ** 2).sum() + (codebooks[j] ** 2).sum(-1).max()
        assert abs(da - db) <= 1e-5 * max(scale, 1.0), (what, r, j, da, db)
    assert len(diff) <= 0.01 * tc.shape[0] * m, (what, len(diff))
    return len(diff)


@pytest.fixture(scope="module", params=["f32", "residual_pq"])
def sequence(request, tmp_path_factory):
    """Both engines through SEQ_STEPS; a snapshot of each after every step."""
    tier = request.param
    ds = jax_make_vector_dataset(n=1200, n_queries=24, dim=16, n_modes=8, seed=17)
    jeng = JaxEngine.build(make_test_mesh(), ds.base, JaxBuildConfig(
        n_partitions=8, k=10, eta=0.03, train_frac=0.4, epochs=2, nprobe_max=8, pq_m=4,
        pq_ks=32, tier=tier, impl="ref"))
    path = tmp_path_factory.mktemp(f"seq-{tier}")
    jeng.save(path)
    teng = LiraEngine.load_jax(path, device="cpu")
    host = np.random.default_rng(23)
    n, d = ds.base.shape
    doomed = host.choice(n, 150, replace=False)
    new_x = (ds.base[host.choice(n, 80, replace=False)]
             + host.normal(0, 0.05, (80, d))).astype(np.float32)
    cents = np.asarray(jeng.store["centroids"])
    free = int(jeng.cfg.capacity * jeng.cfg.n_partitions - np.asarray(jeng.store["occupancy"]).sum())
    hot = (cents[0] + host.normal(0, 0.05, (free + 40, d))).astype(np.float32)
    steps = {
        "delete": lambda e: e.delete(doomed),
        "insert": lambda e: e.insert(new_x, np.arange(80) + 10_000),
        "grow": lambda e: e.insert(hot, np.arange(len(hot)) + 20_000),
        "delete hot": lambda e: e.delete(np.arange(0, len(hot), 2) + 20_000),
        "compact": lambda e: e.compact(),
        "repartition": lambda e: e.maybe_repartition(force=True),
    }
    snaps = {}
    for step in SEQ_STEPS:
        out = [steps[step](e) for e in (jeng, teng)]
        snaps[step] = dict(
            out=out, jax={n: np.asarray(a) for n, a in jeng.store.items()},
            # copies: the port writes same-shape mutations in place
            torch={n: (t.float() if t.dtype == torch.bfloat16 else t.clone()).numpy()
                   for n, t in teng.store.items()},
            epoch=(jeng.epoch, teng.epoch), cap=(jeng.cfg.capacity, teng.cfg.capacity),
            stale=(jeng.staleness(), teng.staleness()),
            search=(jeng.search(ds.queries, sigma=0.3, impl="ref"),
                    teng.search(ds.queries, sigma=0.3, impl="ref")))
    return tier, ds, snaps


@pytest.mark.parametrize("step", SEQ_STEPS)
def test_mutation_sequence_matches_jax(sequence, step):
    tier, ds, snaps = sequence
    snap = snaps[step]
    assert snap["out"][0] == snap["out"][1]
    assert snap["epoch"][0] == snap["epoch"][1] == SEQ_STEPS.index(step) + 1
    assert snap["cap"][0] == snap["cap"][1]
    assert snap["stale"][0] == snap["stale"][1]
    js, ts = snap["jax"], snap["torch"]
    assert set(js) == set(ts)
    for name in ("ids", "occupancy", "vectors", "centroids"):
        np.testing.assert_array_equal(ts[name], js[name], err_msg=f"{step}: {name}")
    if tier == "residual_pq":
        live = js["occupancy"]
        x_res = (js["vectors"] - js["centroids"][:, None, :])[live]
        same = _assert_codes_match(ts["codes"][live], js["codes"][live], x_res,
                                   js["codebooks"], step) == 0
        agree = (ts["codes"][live] == js["codes"][live]).all(-1)
        assert same or not agree.all()
        atol = rt.adc_atol(np.zeros((1, 1, 1), np.float32), js["cterm"][live])
        np.testing.assert_allclose(ts["cterm"][live][agree], js["cterm"][live][agree],
                                   rtol=rt.RTOL, atol=atol)
    jr, tr = snap["search"]
    np.testing.assert_array_equal(tr.nprobe_eff, np.asarray(jr.nprobe_eff))
    assert tr.overflow == jr.overflow and tr.stats.dedup_hits == jr.stats.dedup_hits
    assert tr.stats.epoch == jr.stats.epoch
    rt.assert_topk_match(tr.dists, tr.ids, jr.dists, jr.ids,
                         rt.l2_atol(ds.queries, ts["vectors"], ts["ids"]), what=step)


def test_sequence_grows_compacts_and_repartitions(sequence):
    """The sequence does what its steps are named for."""
    _, _, snaps = sequence
    caps = [snaps[s]["cap"][1] for s in SEQ_STEPS]
    assert caps[0] == caps[1] < caps[2] == caps[3]            # only "grow" grows
    assert caps[4] < caps[3]                                  # compaction shrinks
    assert snaps["delete"]["out"][1] > 0 and snaps["repartition"]["out"][1] is True
    assert snaps["repartition"]["stale"][1] == 0.0


# ------------------------------------------------------------- the port's own

def _build(x, tier, **kw):
    cfg = dict(n_partitions=8, k=10, eta=0.03, train_frac=0.4, epochs=2, nprobe_max=8,
               pq_m=4, pq_ks=32, tier=tier)
    cfg.update(kw)
    return LiraEngine.build(x, BuildConfig(**cfg), device="cpu")


@pytest.mark.parametrize("tier", TIERS)
def test_tombstone_holes_equal_the_compacted_store(tier):
    """After deletes, holes never surface ids nor move the survivors'
    distances: the tombstoned store serves the bits of its compact()-ed
    rebuild. nq = 13 pads to bucket 16, so padding rows are in play too."""
    ds = make_vector_dataset(n=800, n_queries=13, dim=16, n_modes=8, seed=29)
    eng = _build(ds.base, tier, epochs=1, train_frac=0.5)
    dead = np.random.default_rng(31).choice(len(ds.base), 160, replace=False)
    eng.delete(dead)
    holey = eng.search(SearchRequest(queries=ds.queries, sigma=-1.0))
    assert not np.isin(dead, holey.ids).any()
    live = np.setdiff1d(np.arange(len(ds.base)), dead)
    assert np.isin(holey.ids[holey.ids >= 0], live).all()
    cap = eng.cfg.capacity
    eng.compact()
    assert eng.cfg.capacity < cap
    dense = eng.search(SearchRequest(queries=ds.queries, sigma=-1.0))
    np.testing.assert_array_equal(holey.ids, dense.ids)
    np.testing.assert_array_equal(holey.dists, dense.dists)


@pytest.mark.parametrize("tier", TIERS)
def test_sustained_churn_recall_matches_fresh_rebuild(tier):
    """≥20% of the base churned with periodic maybe_repartition: recall@10
    within 0.02 of an index freshly built over the surviving set, at equal
    fixed fan-out (σ = -1 on both sides)."""
    ds = make_vector_dataset(n=2000, n_queries=32, dim=16, n_modes=8, seed=17)
    host = np.random.default_rng(23)
    eng = _build(ds.base, tier)
    n = len(ds.base)
    doomed = host.choice(n, 300, replace=False)
    new_x = (ds.base[host.choice(n, 250, replace=False)]
             + host.normal(0, 0.05, (250, ds.base.shape[1]))).astype(np.float32)
    new_ids = np.arange(250, dtype=np.int32) + 10_000
    assert (len(doomed) + len(new_x)) / n >= 0.20
    for i in range(5):
        eng.delete(doomed[i * 60:(i + 1) * 60])
        eng.insert(new_x[i * 50:(i + 1) * 50], new_ids[i * 50:(i + 1) * 50])
        eng.maybe_repartition()
    eng.maybe_repartition(force=True)
    keep = np.setdiff1d(np.arange(n), doomed)
    all_x = np.concatenate([ds.base[keep], new_x], 0)
    all_ids = np.concatenate([keep.astype(np.int32), new_ids], 0)
    fresh = _build(all_x, tier)
    _, gti = gt.exact_knn(ds.queries, all_x, 10, device="cpu")
    gt_ids = all_ids[np.asarray(gti)]
    r_churn = eng.search(ds.queries, sigma=-1.0)
    r_fresh = fresh.search(ds.queries, sigma=-1.0)
    rec_churn = recall_at_k(r_churn.ids, gt_ids, 10)
    rec_fresh = recall_at_k(all_ids[r_fresh.ids], gt_ids, 10)
    assert not np.isin(doomed, r_churn.ids).any()
    assert rec_churn >= rec_fresh - 0.02, (rec_churn, rec_fresh)


def test_residual_encode_rows_reproduces_build_encoding():
    """Re-encoding a stored row at its own partition gives the build's codes
    and cross terms bit for bit, so a repartition leaves unmoved rows as
    they were."""
    ds = make_vector_dataset(n=600, n_queries=4, dim=16, n_modes=8, seed=41)
    eng = _build(ds.base, "residual_pq", epochs=1, train_frac=0.5, eta=0.0)
    pb, ps = torch.nonzero(eng.store["occupancy"], as_tuple=True)
    pick = torch.from_numpy(np.random.default_rng(0).choice(len(pb), 50, replace=False))
    pb, ps = pb[pick], ps[pick]
    rows = tiers.resolve("residual_pq").encode_rows(eng.cfg, eng.store,
                                                    eng.store["vectors"][pb, ps], pb)
    assert torch.equal(rows["codes"], eng.store["codes"][pb, ps])
    assert torch.equal(rows["cterm"], eng.store["cterm"][pb, ps])
    assert torch.equal(rows["vectors"], eng.store["vectors"][pb, ps])


def test_same_shape_mutations_write_in_place_and_keep_the_cache():
    reg = MetricsRegistry()
    eng, cents, host = raw_engine(metrics=reg)
    q = cents[:2] + 0.01
    r0 = eng.search(q)
    assert r0.stats.epoch == 0 and not r0.stats.cache_hit
    ptrs = {n: t.data_ptr() for n, t in eng.store.items()}
    store = eng.store
    assert eng.delete([0, 1, 19]) == 3
    x_new = cents[1] + host.normal(0, 0.2, (4, 16)).astype(np.float32)
    assert eng.insert(x_new, np.arange(4) + 500) == 4     # fits free slots
    assert eng.store is store
    assert {n: t.data_ptr() for n, t in eng.store.items()} == ptrs
    assert reg.counter("lira_engine_capacity_grows_total").total() == 0
    r1 = eng.search(q)
    assert r1.stats.cache_hit and r1.stats.epoch == 2
    assert reg.counter("lira_engine_jit_cache_hits_total").total() == 1
    assert reg.counter("lira_engine_jit_cache_misses_total").total() == 1
    assert reg.counter("lira_engine_epoch_bumps_total").total() == 2
    assert reg.counter("lira_engine_shape_epoch_bumps_total").total() == 0
    assert reg.gauge("lira_engine_epoch").value() == float(eng.epoch) == 2.0
    assert reg.gauge("lira_engine_tombstone_slots").value() > 0
    assert reg.gauge("lira_engine_live_slots").value() == 4 * 18 - 3 + 4
    assert not np.isin([0, 1, 19], r1.ids).any()
    assert 500 in eng.search(x_new[:2]).ids[0]
    # a repartition whose layout fits rewrites the planes in place too
    assert eng.maybe_repartition(force=True)
    assert {n: t.data_ptr() for n, t in eng.store.items()} == ptrs
    assert eng.search(q).stats.cache_hit


def test_insert_grow_is_a_shape_epoch_and_drops_the_cache():
    reg = MetricsRegistry()
    eng, cents, host = raw_engine(live_per_part=24, metrics=reg)   # every slot full
    q = cents[:2] + 0.01
    eng.search(q)
    old_cap, old_vectors = eng.cfg.capacity, eng.store["vectors"]
    x_new = cents[0] + host.normal(0, 0.2, (3, 16)).astype(np.float32)
    eng.insert(x_new, [900, 901, 902])
    assert eng.cfg.capacity >= int(np.ceil(1.5 * old_cap))
    assert eng.store["vectors"].shape[1] == eng.cfg.capacity
    assert eng.store["vectors"].data_ptr() != old_vectors.data_ptr()
    assert reg.counter("lira_engine_capacity_grows_total").total() == 1
    assert reg.counter("lira_engine_shape_epoch_bumps_total").total() == 1
    assert eng._serve_cache == {}
    assert not eng.search(q).stats.cache_hit
    assert 900 in eng.search(x_new[:2]).ids[0]


def test_delete_unknown_ids_is_a_noop_without_epoch_bump():
    eng, _, _ = raw_engine(metrics=MetricsRegistry())
    occ = eng.store["occupancy"].clone()
    assert eng.delete([99999, 88888]) == 0
    assert eng.epoch == 0 and torch.equal(eng.store["occupancy"], occ)


def test_compact_reclaims_tombstones_and_floors_at_k():
    reg = MetricsRegistry()
    eng, _, _ = raw_engine(metrics=reg)
    eng.delete(np.arange(10))                             # partition 0 thins
    old_cap = eng.cfg.capacity
    reclaimed = eng.compact()
    assert reclaimed == (old_cap - eng.cfg.capacity) * eng.cfg.n_partitions
    assert eng.cfg.capacity == 18                          # the largest live count
    assert reg.counter("lira_engine_compactions_total").total() == 1
    occ, ids = eng.store["occupancy"], eng.store["ids"]
    assert not (~occ & (ids >= 0)).any()                  # tombstones healed
    eng.delete(ids[occ])
    eng.compact()
    assert eng.cfg.capacity == eng.cfg.k                  # the top-k keeps k slots


def test_staleness_gates_repartition_and_resets():
    reg = MetricsRegistry()
    eng, cents, _ = raw_engine(metrics=reg)
    assert eng.staleness() == 0.0
    assert not eng.maybe_repartition()                    # below the threshold
    assert eng.epoch == 0
    eng.delete(np.arange(30))
    assert eng.staleness() >= eng.cfg.repartition_threshold
    assert eng.maybe_repartition()
    assert eng.staleness() == 0.0
    assert reg.counter("lira_engine_repartitions_total").total() == 1
    assert reg.histogram("lira_engine_partition_staleness").count() >= eng.cfg.n_partitions
    # every live row sits in its argmin partition
    pb, ps = torch.nonzero(eng.store["occupancy"], as_tuple=True)
    x = eng.store["vectors"][pb, ps].numpy()
    d2 = (x * x).sum(1)[:, None] - 2.0 * x @ cents.T + (cents * cents).sum(1)[None, :]
    assert (d2.argmin(1) == pb.numpy()).all()


def test_misassigned_inserts_count_toward_staleness():
    eng, cents, host = raw_engine(live_per_part=24)       # every slot full...
    eng.delete(np.asarray([24]))                          # ...but one in partition 1
    x = cents[0] + host.normal(0, 0.1, (1, 16)).astype(np.float32)
    eng.insert(x, [777])                                  # its argmin is full
    assert int(eng._staleness_counters().sum()) == 1
    assert 777 in eng.search(np.concatenate([x, x])).ids[0]
