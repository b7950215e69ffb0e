"""Cluster serving in the port (``repro_torch.serving.cluster``), held against
the reference's ``LiraCluster`` on the CPU.

- ``plan_shards``: the hash and the balanced k-means plans equal the
  reference's array for array.
- A JAX cluster (two shards, two replicas each) and the port's cluster over
  the same shard engines (each saved by JAX and read with ``load_jax``, the
  same ``row_ids``) serve one request sequence with a mid-stream replica
  kill, a straggler that draws hedges, and a stalled replica caught by
  ``tick``, both under a ``FakeClock`` and ``fixed_service_s``: answers
  under ``repro_torch.testing``'s rule, and ``routes``, ``hedged``,
  ``failovers``, ``dedup_hits``, ``overflow`` and ``nprobe_eff`` equal.
- Shards trained on a narrow and a wide fraction of their rows (4 hash
  shards, each package building its own): at each fraction the port's
  probes and recall track the reference's, and in both the narrow fraction
  saturates the probes, overflows q_cap and loses recall.
- Union-oracle parity for the three tiers: a 2-shard × 2-replica cluster
  built by the port against one port engine over the union corpus, at σ =
  -1 and rerank·k ≥ capacity (every partition scanned, every shortlist whole),
  under the comparison rule; η > 0 throughout, so no id repeats in a row.
- The control plane on port clusters: mid-stream failure, heartbeat stall,
  a whole dead group, ``charge_service``, routing spread, hedging on and off,
  and a front-end over the cluster.
"""
import dataclasses

import numpy as np
import pytest

from repro.launch.mesh import make_test_mesh as jax_make_test_mesh
from repro.serving import BuildConfig as JaxBuildConfig
from repro.serving import ClusterConfig as JaxClusterConfig
from repro.serving import LiraCluster as JaxCluster
from repro.serving import plan_shards as jax_plan_shards
from repro.utils.clock import FakeClock as JaxFakeClock
from repro_torch import testing as rt
from repro_torch.configs.base import FrontendConfig
from repro_torch.data.synthetic import make_vector_dataset
from repro_torch.obs import MetricsRegistry
from repro_torch.serving.api import BuildConfig, SearchRequest
from repro_torch.serving.cluster import ClusterConfig, LiraCluster, plan_shards
from repro_torch.serving.engine import LiraEngine
from repro_torch.utils.clock import FakeClock

N, NQ, DIM, K = 360, 16, 16, 5
B_SHARD, B_ORACLE = 4, 8
TIERS = ("f32", "pq", "residual_pq")
SERVICE_S = 1e-3


def _bc(tier, n_partitions=B_SHARD):
    return BuildConfig(n_partitions=n_partitions, k=K, eta=0.05, train_frac=0.5, epochs=2,
                       nprobe_max=n_partitions, tier=tier, pq_m=4, pq_ks=32, rerank=64,
                       seed=9)


@pytest.fixture(scope="module")
def ds():
    return make_vector_dataset(n=N, n_queries=NQ, dim=DIM, n_modes=8, seed=3)


@pytest.fixture(scope="module")
def rigs(ds):
    """Per tier: (port 2-shard × 2-replica cluster, port union-corpus engine)."""
    out = {}
    for tier in TIERS:
        cluster = LiraCluster.build(ds.base, _bc(tier), ClusterConfig(n_shards=2, n_replicas=2,
                                                                      seed=1),
                                    device="cpu", clock=FakeClock(), fixed_service_s=SERVICE_S)
        oracle = LiraEngine.build(ds.base, _bc(tier, B_ORACLE), device="cpu")
        out[tier] = (cluster, oracle)
    return out


def _rewrap(cluster, ccfg, **kwargs):
    """A fresh control plane over already built shard engines."""
    return LiraCluster([g.engine for g in cluster.groups], [g.row_ids for g in cluster.groups],
                       dataclasses.replace(ccfg, n_shards=len(cluster.groups)), **kwargs)


def atol_for(cluster, q):
    return max(rt.l2_atol(q, g.engine.store["vectors"], g.engine.store["ids"])
               for g in cluster.groups)


# ----------------------------------------------------------- shard planning

@pytest.mark.parametrize("mode, n_shards, seed, slack", (
    ("hash", 4, 0, 1.2), ("hash", 3, 0, 1.2), ("kmeans", 4, 5, 1.2), ("kmeans", 2, 1, 1.05),
    ("kmeans", 3, 7, 1.5)))
def test_plan_shards_equals_reference(mode, n_shards, seed, slack):
    x = np.random.default_rng(seed).normal(size=(400, 8)).astype(np.float32)
    ids = np.arange(400, dtype=np.int64) * 7 + 3
    got = plan_shards(x, n_shards, mode=mode, ids=ids, seed=seed, balance_slack=slack)
    want = jax_plan_shards(x, n_shards, mode=mode, ids=ids, seed=seed, balance_slack=slack)
    assert (got.mode, got.n_shards) == (want.mode, want.n_shards)
    np.testing.assert_array_equal(got.assign, want.assign)
    assert got.assign.dtype == want.assign.dtype
    if mode == "kmeans":
        np.testing.assert_array_equal(got.centroids, want.centroids)
        assert np.bincount(got.assign).max() <= int(np.ceil(400 / n_shards * slack))
    else:
        assert got.centroids is None and want.centroids is None


def test_plan_shards_validates():
    x = np.zeros((10, 4), np.float32)
    with pytest.raises(ValueError, match="n_shards"):
        plan_shards(x, 0)
    with pytest.raises(ValueError, match="unknown shard mode"):
        plan_shards(x, 2, mode="range")


# ---------------------------------------------- against the JAX cluster

@pytest.fixture(scope="module")
def jax_pair(ds, tmp_path_factory):
    """A JAX cluster (residual_pq shards, which serve f32 too) and, per call,
    the port's cluster over the same shard engines read with ``load_jax``."""
    jc = JaxCluster.build(jax_make_test_mesh(), ds.base, JaxBuildConfig(
        n_partitions=B_SHARD, k=K, eta=0.05, train_frac=0.5, epochs=2, nprobe_max=B_SHARD,
        tier="residual_pq", pq_m=4, pq_ks=32, rerank=4, seed=9, impl="ref"),
        JaxClusterConfig(n_shards=2, n_replicas=2, seed=1))
    engines = []
    for g in jc.groups:
        path = tmp_path_factory.mktemp(f"shard{g.sid}")
        g.engine.save(path)
        engines.append(LiraEngine.load_jax(path, device="cpu"))
    return jc, engines


def _script(cluster, reg, clock, q):
    """One request sequence: healthy traffic, a replica killed with a batch
    in flight, a straggler that draws hedges, a stalled replica failed by
    ``tick``. Returns every answer and what the control plane did."""
    out = []

    def step(tier, sigma=0.5, rows=slice(None)):
        r = cluster.search(q[rows], sigma=sigma, tier=tier)
        out.append((r, tier))

    for i in range(3):
        step("f32" if i % 2 else "residual_pq")
    cluster.fail_replica(0, 0, inflight=True)
    for i in range(3):
        step("residual_pq" if i % 2 else "f32", sigma=-1.0)
    for g in cluster.groups:
        g.router.replicas[0].latency_scale = 50.0
    for i in range(6):
        step("f32", rows=slice(0, 8))
    cluster.stall_replica(1, 1)
    clock.advance(20.0)
    failed = cluster.tick()
    for i in range(2):
        step("residual_pq", rows=slice(3, 12))
    table = [(r["shard"], r["replica"], r["healthy"], r["served"], r["ewma"], r["busy_s"],
              r["stalled"]) for r in cluster.replica_table()]
    counters = [reg.counter(n).total() for n in (
        "lira_failovers_total", "lira_hedges_total", "lira_hedge_wins_total",
        "lira_cluster_searches_total", "lira_cluster_merge_dedup_hits_total")]
    return out, failed, table, counters


def test_cluster_over_jax_shard_engines_matches_jax_cluster(jax_pair, ds):
    jc, engines = jax_pair
    ccfg = dict(n_shards=2, n_replicas=2, seed=1, hedge_warmup=4, heartbeat_timeout_s=10.0)
    jclock, tclock = JaxFakeClock(), FakeClock()
    from repro.obs import MetricsRegistry as JaxRegistry
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jax_cl = JaxCluster([g.engine for g in jc.groups], [g.row_ids for g in jc.groups],
                        JaxClusterConfig(**ccfg), clock=jclock, fixed_service_s=SERVICE_S,
                        metrics=jreg, charge_service=True)
    port_cl = LiraCluster(engines, [g.row_ids for g in jc.groups], ClusterConfig(**ccfg),
                          clock=tclock, fixed_service_s=SERVICE_S, metrics=treg,
                          charge_service=True)
    j_out, j_failed, j_table, j_counters = _script(jax_cl, jreg, jclock, ds.queries)
    t_out, t_failed, t_table, t_counters = _script(port_cl, treg, tclock, ds.queries)
    assert (t_failed, t_table, t_counters) == (j_failed, j_table, j_counters)
    assert t_counters[0] == 1 and t_counters[1] > 0 and t_failed == [(1, 1, 0)]
    assert tclock() == pytest.approx(jclock())
    atol = atol_for(port_cl, ds.queries)
    for (tr, tier), (jr, _) in zip(t_out, j_out):
        ts, js = tr.stats, jr.stats
        assert (ts.routes, ts.hedged, ts.failovers, ts.dedup_hits, ts.bucket, ts.tier) == (
            js.routes, js.hedged, js.failovers, js.dedup_hits, js.bucket, js.tier)
        assert ts.latency_ms == pytest.approx(js.latency_ms)
        assert tr.overflow == jr.overflow
        np.testing.assert_array_equal(tr.nprobe_eff, np.asarray(jr.nprobe_eff))
        rt.assert_topk_match(tr.dists, tr.ids, jr.dists, jr.ids, atol, what=tier)
    assert any(t.stats.failovers for t, _ in t_out) and any(t.stats.hedged for t, _ in t_out)


# ------------------------------------- shard training subsets, both packages

NARROW, WIDE = 0.1, 0.4   # a single engine's train_frac, and 4× it for 4 shards


@pytest.fixture(scope="module")
def frac_clusters():
    """Per train_frac: (JAX cluster's, port cluster's) (recall@k against the
    exact top-k, overflow, mean nprobe_eff) over one corpus, four hash shards,
    each package building its own shards from one BuildConfig. A shard's
    probing labels are the k-NN within its training subset, so the fraction
    sets how far they reach; B = 16 a shard with nprobe_max = 4 leaves the
    q_cap room for about 4 probes a query a shard."""
    ds = make_vector_dataset(n=12_000, n_queries=200, dim=16, n_modes=16, seed=3)
    x, q, k = ds.base, ds.queries, 20
    d = (q * q).sum(1)[:, None] - 2 * q @ x.T + (x * x).sum(1)[None]
    exact = np.argsort(d, 1, kind="stable")[:, :k]

    def read(res):
        ids = np.asarray(res.ids)
        recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, exact)])
        return recall, res.overflow, float(np.mean(res.nprobe_eff))

    out = {}
    for frac in (NARROW, WIDE):
        kw = dict(n_partitions=16, k=k, eta=0.03, train_frac=frac, nprobe_max=4, seed=0)
        jc = JaxCluster.build(jax_make_test_mesh(), x, JaxBuildConfig(impl="ref", **kw),
                              JaxClusterConfig(n_shards=4, n_replicas=1, seed=0))
        tc = LiraCluster.build(x, BuildConfig(**kw), ClusterConfig(n_shards=4, n_replicas=1,
                                                                   seed=0), device="cpu")
        out[frac] = (read(jc.search(q, sigma=0.5)), read(tc.search(q, sigma=0.5)))
    return out


@pytest.mark.parametrize("frac", (NARROW, WIDE))
def test_shard_recall_tracks_jax_at_train_frac(frac_clusters, frac):
    """At each fraction the port's shards probe about as many partitions as
    the reference's and reach its recall, within the reference's own spread:
    the two packages draw k-means, the subset and the model's weights from
    different generators, and the reference alone moves by 20% in mean
    nprobe_eff and 0.12 in recall between build seeds 0 and 1 here."""
    (j_rec, _, j_np), (t_rec, _, t_np) = frac_clusters[frac]
    assert t_np == pytest.approx(j_np, rel=0.25)
    assert abs(t_rec - j_rec) <= 0.12


def test_narrow_train_frac_saturates_probes_in_both_packages(frac_clusters):
    """The narrow fraction's labels reach farther: in the reference as in
    the port the shards probe more partitions, drop more probes at q_cap
    and lose recall against the wide fraction."""
    for pkg in (0, 1):
        (rec_n, ovf_n, np_n), (rec_w, ovf_w, np_w) = (frac_clusters[NARROW][pkg],
                                                      frac_clusters[WIDE][pkg])
        assert np_n > np_w and ovf_n > ovf_w and rec_n < rec_w, pkg


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("tier", TIERS)
def test_cluster_matches_union_oracle(rigs, ds, tier):
    cluster, oracle = rigs[tier]
    rc = cluster.search(SearchRequest(queries=ds.queries, sigma=-1.0))
    ro = oracle.search(SearchRequest(queries=ds.queries, sigma=-1.0))
    rt.assert_topk_match(rc.dists, rc.ids, ro.dists, ro.ids, atol_for(cluster, ds.queries),
                         what=f"{tier} cluster vs union")
    for row in rc.ids:   # η > 0 replicas collapsed through both merge levels
        valid = row[row >= 0]
        assert len(set(valid)) == len(valid)


def test_merged_answer_is_the_host_merge_of_the_shard_engines(rigs, ds):
    """The cluster's answer is ``dedup_topk_np`` of the shard engines' own
    searches with ids mapped to global, bit for bit; a cluster of two shards
    holding the same rows collapses every id."""
    from repro_torch.kernels.ref import dedup_topk_np

    cluster, _ = rigs["f32"]
    res = cluster.search(SearchRequest(queries=ds.queries, sigma=0.5))
    per = [g.engine.search(ds.queries, sigma=0.5) for g in cluster.groups]
    pool_i = np.concatenate([np.where(r.ids >= 0, g.row_ids[np.clip(r.ids, 0, None)], -1)
                             for r, g in zip(per, cluster.groups)], 1)
    d, i = dedup_topk_np(np.concatenate([r.dists for r in per], 1), pool_i, K)
    np.testing.assert_array_equal(res.dists, d)
    np.testing.assert_array_equal(res.ids, i)
    g = cluster.groups[0]
    twin = LiraCluster([g.engine, g.engine], [g.row_ids, g.row_ids],
                       ClusterConfig(n_shards=2, n_replicas=1, seed=0), clock=FakeClock(),
                       fixed_service_s=SERVICE_S)
    solo = g.engine.search(SearchRequest(queries=ds.queries, sigma=-1.0))
    both = twin.search(SearchRequest(queries=ds.queries, sigma=-1.0))
    np.testing.assert_array_equal(both.dists, solo.dists)
    np.testing.assert_array_equal(both.ids, np.where(solo.ids >= 0,
                                                     g.row_ids[np.clip(solo.ids, 0, None)], -1))
    assert both.stats.dedup_hits >= NQ * K


@pytest.mark.parametrize("tier", TIERS)
def test_midstream_replica_failure_preserves_answers(rigs, ds, tier):
    cluster, oracle = rigs[tier]
    cl = _rewrap(cluster, ClusterConfig(n_replicas=2, seed=1), clock=FakeClock(),
                 fixed_service_s=SERVICE_S, metrics=MetricsRegistry())
    want = cluster.search(SearchRequest(queries=ds.queries, sigma=-1.0))
    cl.fail_replica(0, 0, inflight=True)
    for _ in range(6):
        got = cl.search(SearchRequest(queries=ds.queries, sigma=-1.0))
        np.testing.assert_array_equal(got.dists, want.dists)
        np.testing.assert_array_equal(got.ids, want.ids)
    router = cl.groups[0].router
    assert router.requeued == 1 and not router.replicas[0].healthy
    assert sum(r.served for r in router.replicas) >= 6
    assert cl.metrics.counter("lira_failovers_total").total() == 1.0


# ------------------------------------------------------------ control plane

def test_routing_spreads_load_across_replicas(rigs, ds):
    cl = _rewrap(rigs["f32"][0], ClusterConfig(n_replicas=2, seed=3), clock=FakeClock(),
                 fixed_service_s=SERVICE_S)
    for _ in range(24):
        cl.search(SearchRequest(queries=ds.queries[:8], sigma=-1.0))
    for g in cl.groups:
        served = [r.served for r in g.router.replicas]
        assert sum(served) == 24 and min(served) > 0


@pytest.mark.parametrize("hedging", (True, False))
def test_hedging_bounds_straggler_latency(rigs, ds, hedging):
    reg = MetricsRegistry()
    cl = _rewrap(rigs["f32"][0], ClusterConfig(n_replicas=2, seed=2, hedge_warmup=4,
                                               hedging=hedging),
                 clock=FakeClock(), fixed_service_s=SERVICE_S, metrics=reg)
    req = SearchRequest(queries=ds.queries[:8], sigma=-1.0)
    for _ in range(4):
        cl.search(req)
    for g in cl.groups:
        g.router.replicas[0].latency_scale = 50.0
    lats = [cl.search(req).stats.latency_ms for _ in range(20)]
    if hedging:
        assert reg.counter("lira_hedges_total").total() > 0
        assert reg.counter("lira_hedge_wins_total").total() > 0
        assert max(lats) < 50.0 * SERVICE_S * 1e3
    else:
        assert reg.counter("lira_hedges_total").total() == 0
        assert max(lats) == pytest.approx(50.0 * SERVICE_S * 1e3)


def test_heartbeat_stall_detected_and_routed_around(rigs, ds):
    clock = FakeClock()
    cl = _rewrap(rigs["f32"][0], ClusterConfig(n_replicas=2, seed=1, heartbeat_timeout_s=5.0),
                 clock=clock, fixed_service_s=SERVICE_S)
    cl.stall_replica(0, 1)
    clock.advance(10.0)
    assert cl.tick() == [(0, 1, 0)]
    assert not cl.groups[0].router.replicas[1].healthy
    for _ in range(6):
        res = cl.search(SearchRequest(queries=ds.queries[:8], sigma=-1.0))
        assert res.stats.routes[0][1] == 0
    cl.recover_replica(0, 1)
    assert cl.groups[0].router.replicas[1].healthy


def test_whole_group_dead_raises(rigs, ds):
    cl = _rewrap(rigs["f32"][0], ClusterConfig(n_replicas=2, seed=1), clock=FakeClock(),
                 fixed_service_s=SERVICE_S)
    cl.fail_replica(1, 0)
    cl.fail_replica(1, 1)
    with pytest.raises(RuntimeError, match="no healthy replicas"):
        cl.search(SearchRequest(queries=ds.queries[:8], sigma=-1.0))


def test_charge_service_advances_clock(rigs, ds):
    clock = FakeClock()
    cl = _rewrap(rigs["f32"][0], ClusterConfig(n_replicas=1, seed=0), clock=clock,
                 fixed_service_s=SERVICE_S, charge_service=True)
    cl.search(SearchRequest(queries=ds.queries[:8], sigma=-1.0))
    assert clock() == pytest.approx(SERVICE_S)
    with pytest.raises(TypeError, match="advance"):
        _rewrap(rigs["f32"][0], ClusterConfig(n_replicas=1, seed=0), charge_service=True)


# --------------------------------------------------------- stats & surface

def test_cluster_stats_and_surface(rigs, ds):
    cluster, _ = rigs["f32"]
    res = cluster.search(SearchRequest(queries=ds.queries, sigma=-1.0))
    st = res.stats
    assert st.shard is None and st.replica is None and len(st.routes) == 2
    for sid, rid, hedged, failovers in st.routes:
        assert 0 <= rid < 2 and isinstance(hedged, bool) and failovers == 0
    assert st.latency_ms == pytest.approx(SERVICE_S * 1e3)
    assert st.bucket >= NQ and st.failovers == 0 and not st.hedged
    assert res.nprobe_eff.shape == (NQ,)
    assert len(cluster.replica_table()) == 4
    assert all(row["healthy"] for row in cluster.replica_table())
    a = cluster.search(ds.queries[:8], sigma=-1.0)
    np.testing.assert_array_equal(a.dists, res.dists[:8])
    assert cluster.search(ds.queries[0], sigma=-1.0).dists.shape == (1, K)
    with pytest.raises(TypeError, match="not both"):
        cluster.search(SearchRequest(queries=ds.queries[:8]), sigma=-1.0)
    with pytest.raises(ValueError, match="row_ids"):
        LiraCluster([], [])
    with pytest.raises(ValueError, match="shards"):
        LiraCluster([object()], [np.arange(3)], ClusterConfig(n_shards=2))


def test_frontend_over_cluster_equals_a_direct_search(rigs, ds):
    cl = _rewrap(rigs["f32"][0], ClusterConfig(n_replicas=2, seed=1), clock=FakeClock(),
                 fixed_service_s=SERVICE_S)
    fe = cl.attach_frontend(FrontendConfig(max_batch=8, max_wait_ms=5.0, max_queue=64),
                            clock=FakeClock(), metrics=MetricsRegistry())
    try:
        pend = [fe.submit(SearchRequest(queries=ds.queries[i], sigma=-1.0)) for i in range(3)]
        last = cl.search_one(SearchRequest(queries=ds.queries[3], sigma=-1.0))
        fe.drain()
        direct = cl.search(SearchRequest(queries=ds.queries[:4], sigma=-1.0))
        for i, r in enumerate([p.result() for p in pend] + [last]):
            np.testing.assert_array_equal(r.dists[0], direct.dists[i])
            np.testing.assert_array_equal(r.ids[0], direct.ids[i])
            assert not r.stats.shed
    finally:
        cl.frontend = None
