"""The port's host evaluation path against the JAX reference, on the CPU, from
the same numpy inputs (a few thousand points at d = 32 from a numpy seed):
the evaluation engine (``core/retrieval``), the paper metrics, the kNN
partition distributions, ``store_stats``, ``predicted_nprobe``, the
two-level index and the four baselines. The cases mirror
``tests/test_core_lira.py`` (k-means store, IVF full probe, recall monotone
in nprobe, LIRA vs IVF, probe masks with the argmax, fuzzy IVF, IVFPQ, BLISS)
and ``tests/test_serving_dedup.py:95``
(``test_evaluate_probe_matches_setloop_oracle``: replica-heavy partition
lists merged by ``evaluate_probe``).

Rules:
  * ``partition_topk`` is held against the reference's under the port's
    comparison rule (``repro_torch.testing``: distances within rtol 1e-5,
    atol 1e-5 · max(‖q‖² + ‖c‖²); ids set-equal up to exact ties);
  * everything after ``partition_topk`` is numpy, so on the reference's own
    ``PartitionTopK`` the probe policies, ``merge_topk``,
    ``evaluate_probe`` and ``merge_groups`` must give identical results,
    as must the distributions, the metrics and ``store_stats``;
  * the k-means-built structures (two-level index, IVF, fuzzy IVF, IVFPQ)
    start from the reference's own k-means++ starts (``jax.random``'s
    streams are not torch's) and must agree within rtol 1e-5 / atol 1e-3
    on centroids, with equal assignments and layouts;
  * BLISS starts from the reference's initial assignments and MLP weights;
    its SGD runs in another summation order, and an argmax re-partition
    turns last-bit differences into different partitions, so at least 95%
    of the final assignments must be equal and the recall of the merged
    groups within 0.05 of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import ground_truth as jgt
from repro.core import kmeans as jkm
from repro.core import metrics as jmetrics
from repro.core import partitions as jpart
from repro.core import probing as jprobing
from repro.core import retrieval as jret
from repro_torch import testing as rt
from repro_torch.core import baselines as tbase
from repro_torch.core import ground_truth as tgt
from repro_torch.core import metrics as tmetrics
from repro_torch.core import partitions as tpart
from repro_torch.core import probing as tprobing
from repro_torch.core import retrieval as tret

K, B = 10, 16


@pytest.fixture(scope="module")
def data():
    """Clustered points at d = 32 with replicas (300 points copied into a
    second partition, so ids repeat across lists), the reference's k-means
    partition, ground truth, and both packages' stores of the same rows."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(24, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 24, 4000)] + rng.normal(size=(4000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 80)] + rng.normal(size=(80, 32))).astype(np.float32)
    st = jkm.kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(x), n_clusters=B, n_iters=10)
    assign, cents = np.array(st.assign), np.array(st.centroids)
    ids = np.arange(len(x), dtype=np.int32)
    rep = rng.choice(len(x), 300, replace=False)
    extra = (x[rep], ids[rep], ((assign[rep] + 1) % B).astype(np.int32))
    jstore = jpart.build_store(x, ids, assign, cents, extra=extra)
    tstore = tpart.build_store(x, ids, assign, cents, extra=extra, device="cpu")
    _, gti = jgt.exact_knn(q, x, K)
    return x, q, assign, cents, gti, jstore, tstore


@pytest.fixture(scope="module")
def jptk(data):
    _, q, _, _, _, jstore, _ = data
    return jret.partition_topk(jstore, q, K)


def as_port(ptk):
    return tret.PartitionTopK(*ptk)


def assert_same_result(a, b):
    assert (a.recall, a.cmp_mean, a.nprobe_mean) == (b.recall, b.cmp_mean, b.nprobe_mean)
    for f in ("per_query_cmp", "per_query_nprobe", "per_query_recall"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def masks(data, which):
    """Probe masks of each policy over the reference's own inputs."""
    _, q, _, _, _, jstore, _ = data
    cd = np.asarray(jret.lira_inputs(jstore, q))
    p_hat = np.random.default_rng(1).random((len(q), B)).astype(np.float32)
    return {"ivf 1": lambda: jret.probe_ivf(cd, 1),
            "ivf 4": lambda: jret.probe_ivf(cd, 4),
            "ivf all": lambda: jret.probe_ivf(cd, B),
            "lira 0.5": lambda: jret.probe_lira(p_hat, 0.5),
            "lira 0.95": lambda: jret.probe_lira(p_hat, 0.95),
            "topn 3": lambda: jret.probe_topn(p_hat, 3)}[which]()


MASKS = ("ivf 1", "ivf 4", "ivf all", "lira 0.5", "lira 0.95", "topn 3")


# ------------------------------------------------------------ partition_topk

@pytest.mark.parametrize("q_batch", [128, 7])
def test_partition_topk_matches_jax(data, jptk, q_batch):
    _, q, _, _, _, _, tstore = data
    tptk = tret.partition_topk(tstore, q, K, q_batch=q_batch)
    assert tptk.dists.shape == tptk.ids.shape == (len(q), B, K)
    np.testing.assert_array_equal(tptk.counts, jptk.counts)
    rt.assert_topk_match(tptk.dists, tptk.ids, jptk.dists, jptk.ids,
                         rt.l2_atol(q, tstore.vectors.reshape(-1, 32), tstore.ids.reshape(-1)),
                         what="partition_topk")
    # ascending within each partition: the lazy merge relies on it
    assert (tptk.dists[..., 1:] >= tptk.dists[..., :-1]).all()


def test_partition_topk_short_partitions_match_jax():
    """Partitions holding fewer than k rows (one of them none): inf / -1
    tails after the ascending valid rows, and k cut to the capacity."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    q = rng.normal(size=(9, 8)).astype(np.float32)
    assign = np.where(np.arange(40) < 3, 3, np.arange(40) % 3).astype(np.int32)  # 3 rows in 3
    cents = rng.normal(size=(5, 8)).astype(np.float32)                           # 4: empty
    ids = np.arange(40, dtype=np.int32)
    jstore = jpart.build_store(x, ids, assign, cents)
    tstore = tpart.build_store(x, ids, assign, cents, device="cpu")
    for k in (5, 64):
        jp, tp = jret.partition_topk(jstore, q, k), tret.partition_topk(tstore, q, k, q_batch=4)
        assert tp.dists.shape == jp.dists.shape
        rt.assert_topk_match(tp.dists, tp.ids, jp.dists, jp.ids, rt.l2_atol(q, x, ids),
                             what=f"short partitions, k {k}")
        assert (tp.dists[..., 1:] >= tp.dists[..., :-1]).all()
        assert np.isinf(tp.dists[:, 3, 3:]).all() and (tp.ids[:, 3, 3:] == -1).all()
        assert np.isinf(tp.dists[:, 4]).all() and (tp.ids[:, 4] == -1).all()


def test_lira_inputs_match_jax(data):
    _, q, _, cents, _, jstore, tstore = data
    got, want = tret.lira_inputs(tstore, q), np.asarray(jret.lira_inputs(jstore, q))
    atol = 1e-5 * float((q * q).sum(-1).max() + (cents * cents).sum(-1).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


# ------------------------------------------------------------ host evaluation

@pytest.mark.parametrize("which", MASKS)
def test_probe_policies_equal_jax(data, which):
    _, q, _, _, _, jstore, _ = data
    cd = np.asarray(jret.lira_inputs(jstore, q))
    p_hat = np.random.default_rng(1).random((len(q), B)).astype(np.float32)
    name, arg = which.split()
    fn = {"ivf": (tret.probe_ivf, cd), "lira": (tret.probe_lira, p_hat),
          "topn": (tret.probe_topn, p_hat)}[name]
    arg = B if arg == "all" else (float(arg) if name == "lira" else int(arg))
    np.testing.assert_array_equal(fn[0](fn[1], arg), masks(data, which))


@pytest.mark.parametrize("which", MASKS)
def test_evaluate_and_merge_on_the_reference_ptk_are_identical(data, jptk, which):
    gti = data[4]
    mask = masks(data, which)
    assert_same_result(tret.evaluate_probe(as_port(jptk), mask, gti, K),
                       jret.evaluate_probe(jptk, mask, gti, K))
    for pool in (2, 40):
        for got, want in zip(tret.merge_topk(as_port(jptk), mask, K, dedup_pool=pool),
                             jret.merge_topk(jptk, mask, K, dedup_pool=pool)):
            np.testing.assert_array_equal(got, want)


def test_evaluate_probe_replica_heavy_lists_identical():
    """The set-loop oracle's workload (test_serving_dedup.py:95): ~20% of
    ids repeat across lists, half the partitions probed."""
    rng = np.random.default_rng(3)
    qn, b, kk, k = 64, 8, 16, 16
    n_ids = int(b * kk * 0.8)
    ids = rng.integers(0, n_ids, (qn, b, kk)).astype(np.int32)
    dists = np.sort(rng.permuted(np.tile(np.arange(b * kk, dtype=np.float32), (qn, 1)),
                                 axis=1).reshape(qn, b, kk), axis=-1)
    mask = rng.random((qn, b)) < 0.5
    mask[:, 0] = True
    gti = np.argsort(rng.random((qn, n_ids)), axis=1)[:, :k].astype(np.int32)
    jptk = jret.PartitionTopK(dists, ids, np.full(b, kk, np.int32))
    assert_same_result(tret.evaluate_probe(as_port(jptk), mask, gti, k),
                       jret.evaluate_probe(jptk, mask, gti, k))


@pytest.mark.parametrize("which", ["ivf 1", "lira 0.5", "topn 3"])
def test_merge_groups_on_the_reference_ptks_identical(data, jptk, which):
    """Two groups (the store, and the same rows re-partitioned by shifting
    every assignment), BLISS-style: recall from both pools, exact dedup'd
    cmp over the union of probed points."""
    x, q, assign, cents, gti, _, _ = data
    ids = np.arange(len(x), dtype=np.int32)
    shifted = ((assign + 5) % B).astype(np.int32)
    jptk2 = jret.partition_topk(jpart.build_store(x, ids, shifted, cents), q, K)
    m1, m2 = masks(data, which), np.roll(masks(data, which), 1, axis=0)
    got = tret.merge_groups([as_port(jptk), as_port(jptk2)], [m1, m2], gti, K,
                            [assign, shifted], len(x), q_block=32)
    want = jret.merge_groups([jptk, jptk2], [m1, m2], gti, K, [assign, shifted], len(x),
                             q_block=32)
    assert_same_result(got, want)


def test_full_probe_is_exact_and_ivf_recall_monotone(data):
    """The port's own PartitionTopK: a full probe reaches recall 1 with
    every row's merge equal to exact ground truth; IVF recall never drops
    as nprobe grows, and LIRA's cmp counts the probed partitions' rows."""
    x, q, _, _, gti, _, tstore = data
    ptk = tret.partition_topk(tstore, q, K)
    full = np.ones((len(q), B), bool)
    assert tret.evaluate_probe(ptk, full, gti, K).recall == 1.0
    gtd, _ = tgt.exact_knn(q, x, K, device="cpu")
    d, i = tret.merge_topk(ptk, full, K)
    rt.assert_topk_match(d, i, gtd, gti, rt.l2_atol(q, x, np.arange(len(x))), what="full probe")
    cd = tret.lira_inputs(tstore, q)
    recalls = [tret.evaluate_probe(ptk, tret.probe_ivf(cd, n), gti, K).recall for n in range(1, B + 1)]
    assert all(b >= a for a, b in zip(recalls, recalls[1:]))
    res = tret.evaluate_probe(ptk, tret.probe_ivf(cd, 2), gti, K)
    np.testing.assert_array_equal(res.per_query_cmp,
                                  (tret.probe_ivf(cd, 2) * tstore.counts.numpy()).sum(-1))


# ------------------------------------------------------------ distributions, metrics, stats

@pytest.mark.parametrize("fn", ["knn_count_distribution", "knn_partition_labels",
                                "optimal_nprobe", "nprobe_dist"])
def test_knn_distributions_equal_jax(data, fn):
    x, q, assign, cents, gti, _, _ = data
    if fn == "nprobe_dist":
        got, want = (m.nprobe_dist(gti, assign, q, cents) for m in (tgt, jgt))
        assert (got >= tgt.optimal_nprobe(tgt.knn_partition_labels(gti, assign, B))).all()
    elif fn == "optimal_nprobe":
        got, want = (m.optimal_nprobe(m.knn_partition_labels(gti, assign, B)) for m in (tgt, jgt))
    else:
        got, want = (getattr(m, fn)(gti, assign, B) for m in (tgt, jgt))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_metrics_equal_jax(data, jptk):
    gti = data[4]
    res = [jret.evaluate_probe(jptk, masks(data, w), gti, K) for w in MASKS]
    assert ([tmetrics.summarize(w, r) for w, r in zip(MASKS, res)]
            == [jmetrics.summarize(w, r) for w, r in zip(MASKS, res)])
    curve = [(r.cmp_mean, r.recall) for r in res]
    assert tmetrics.pareto_frontier(curve) == jmetrics.pareto_frontier(curve)
    for target in (0.0, 0.5, 0.9, 1.0, 1.1):
        assert tmetrics.cost_at_recall(curve, target) == jmetrics.cost_at_recall(curve, target)


def test_store_stats_equal_jax(data):
    jstore, tstore = data[5], data[6]
    assert tpart.store_stats(tstore) == jpart.store_stats(jstore)


@pytest.mark.parametrize("sigma", [0.3, 0.5])
def test_predicted_nprobe_matches_jax(data, sigma):
    x, q, _, _, _, jstore, tstore = data
    cfg = jprobing.ProbingConfig(dim=32, n_partitions=B, q_hidden=(32, 16), i_hidden=(16,),
                                 p_hidden=(32,))
    params = jax.tree.map(np.asarray, jprobing.init(jax.random.PRNGKey(4), cfg))
    cd = np.array(jret.lira_inputs(jstore, q))
    want = np.asarray(jprobing.predicted_nprobe(params, jnp.asarray(q), jnp.asarray(cd), sigma))
    model = tprobing.params_from_jax(params, device="cpu")
    with torch.no_grad():
        got = model.predicted_nprobe(torch.from_numpy(q), torch.from_numpy(cd), sigma)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ two-level index

def test_attach_internal_index_from_the_reference_starts(data):
    """Each partition's sub-k-means over all its capacity rows, padding
    included, from the reference's k-means++ start of that partition (as its
    vmapped kmeans_fit draws it from jax.random.split)."""
    jstore, tstore = data[5], data[6]
    rng, n_sub = jax.random.PRNGKey(5), 4
    want = jpart.attach_internal_index(jstore, rng, n_sub, n_iters=6)
    starts = np.asarray(jax.vmap(lambda r, v: jkm.plus_plus_init(r, v, n_sub))(
        jax.random.split(rng, B), jstore.vectors))
    got = tpart.attach_internal_index(tstore, n_sub, n_iters=6, init=starts)
    assert got.sub_centroids.shape == (B, n_sub, 32)
    assert got.sub_assign.dtype == torch.int32
    np.testing.assert_allclose(got.sub_centroids.numpy(), np.asarray(want.sub_centroids),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got.sub_assign.numpy(), np.asarray(want.sub_assign))
    # the padding rows (1e6 everywhere) form their own sub-cluster
    pad = tstore.ids.numpy() < 0
    assert pad.any()
    for b in np.flatnonzero(pad.any(1)):
        assert len(set(got.sub_assign.numpy()[b][pad[b]].tolist())) == 1


def test_attach_internal_index_from_a_generator(data):
    tstore = data[6]
    got = tpart.attach_internal_index(tstore, 3, n_iters=2,
                                      generator=torch.Generator().manual_seed(0))
    assert got.sub_centroids.shape == (B, 3, 32) and got.vectors is tstore.vectors
    a = got.sub_assign.numpy()
    assert a.shape == (B, tstore.capacity) and a.min() >= 0 and a.max() < 3
    assert tret.partition_topk(got, data[1][:4], K).dists.shape == (4, B, K)


def test_attach_internal_index_on_short_and_empty_partitions():
    """A partition with fewer distinct rows than sub-clusters (an empty one
    holds only padding): the reference's k-means++ picks row 0 once every
    D² is zero, and so does the port's, so both the reference's starts and
    a generator's run through."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    assign = np.where(np.arange(40) < 2, 3, np.arange(40) % 3).astype(np.int32)
    cents = rng.normal(size=(5, 8)).astype(np.float32)
    ids = np.arange(40, dtype=np.int32)
    jstore = jpart.build_store(x, ids, assign, cents)
    tstore = tpart.build_store(x, ids, assign, cents, device="cpu")
    key, n_sub = jax.random.PRNGKey(8), 4
    want = jpart.attach_internal_index(jstore, key, n_sub, n_iters=3)
    starts = np.asarray(jax.vmap(lambda r, v: jkm.plus_plus_init(r, v, n_sub))(
        jax.random.split(key, 5), jstore.vectors))
    np.testing.assert_array_equal(starts[4], np.full((n_sub, 8), 1e6, np.float32))
    got = tpart.attach_internal_index(tstore, n_sub, n_iters=3, init=starts)
    np.testing.assert_allclose(got.sub_centroids.numpy(), np.asarray(want.sub_centroids),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got.sub_assign.numpy(), np.asarray(want.sub_assign))
    drawn = tpart.attach_internal_index(tstore, n_sub, n_iters=3,
                                        generator=torch.Generator().manual_seed(0))
    assert (drawn.sub_centroids[4] == 1e6).all() and (drawn.sub_assign[4] == 0).all()
    # two distinct rows and padding in partition 3: each is picked once
    assert len({tuple(r) for r in drawn.sub_centroids[3].tolist()}) == 3


# ------------------------------------------------------------ baselines

def assert_same_store(t, j, atol=1e-3):
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_allclose(t.vectors.numpy(), np.asarray(j.vectors), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("kind", ["ivf", "ivf_fuzzy"])
def test_ivf_baselines_from_the_reference_start(data, kind):
    x = data[0]
    rng = jax.random.PRNGKey(6)
    want = getattr(jbase, f"build_{kind}")(rng, x, B, n_iters=8)
    start = np.asarray(jkm.plus_plus_init(rng, jnp.asarray(x), B))
    got = getattr(tbase, f"build_{kind}")(x, B, n_iters=8, init=start, device="cpu")
    assert_same_store(got, want)
    assert tpart.store_stats(got)["total"] == len(x) * (2 if kind == "ivf_fuzzy" else 1)


def test_ivfpq_from_the_reference_starts(data):
    """Coarse k-means and each subspace's codebook k-means from the
    reference's starts (its split of the key: k-means, then PQ). The
    residuals differ in the last bits, so the codebooks' Lloyd runs agree
    within the tolerance and the codes up to near-ties (≥ 99% equal)."""
    x, q, _, _, _, _, _ = data
    rng = jax.random.PRNGKey(7)
    m, ks = 8, 64
    want = jbase.build_ivfpq(rng, x, B, m=m, ks=ks, n_iters=8)
    k1, k2 = jax.random.split(rng)
    start = np.asarray(jkm.plus_plus_init(k1, jnp.asarray(x), B))
    resid = (x - np.asarray(want.store.centroids)[want.assign]).reshape(len(x), m, -1)
    pq_start = np.stack([np.asarray(jkm.plus_plus_init(r, jnp.asarray(resid[:, j]), ks))
                         for j, r in enumerate(jax.random.split(k2, m))])
    got = tbase.build_ivfpq(x, B, m=m, ks=ks, n_iters=8, init=start, pq_init=pq_start,
                            device="cpu")
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_allclose(got.pq.codebooks.numpy(), np.asarray(want.pq.codebooks),
                               rtol=1e-5, atol=1e-3)
    assert got.codes.dtype == want.codes.dtype and (got.codes == want.codes).mean() >= 0.99
    _, gti = jgt.exact_knn(q, x, K)
    full = np.ones((len(q), B), bool)
    r_t = tret.evaluate_probe(tret.partition_topk(got.store, q, K), full, gti, K).recall
    r_j = jret.evaluate_probe(jret.partition_topk(want.store, q, K), full, gti, K).recall
    assert abs(r_t - r_j) <= 0.01 and 0.2 < r_t < 1.0


def _jax_bliss_starts(rng, n, d, b, n_groups, hidden):
    """The reference's per-group random starts, drawn as build_bliss draws them."""
    starts = []
    for _ in range(n_groups):
        rng, kg, ki = jax.random.split(rng, 3)
        assign = np.asarray(jax.random.randint(kg, (n,), 0, b), np.int32)
        starts.append((assign, jax.tree.map(np.asarray, jbase._mlp_init(ki, (d, hidden, b)))))
    return starts


def test_bliss_from_the_reference_starts(data):
    x, q = data[0][:2048], data[1]
    b, hidden, groups = 8, 32, 2
    _, knn = jgt.exact_knn(x, x, 5, exclude_self=True)
    rng = jax.random.PRNGKey(3)
    want = jbase.build_bliss(rng, x, b, n_groups=groups, knn_ids=knn, reparts=2, epochs=2,
                             hidden=hidden)
    got = tbase.build_bliss(x, b, n_groups=groups, knn_ids=knn, reparts=2, epochs=2,
                            hidden=hidden, init=_jax_bliss_starts(rng, len(x), 32, b, groups,
                                                                  hidden),
                            device="cpu")
    same = np.mean([(g.assign == w.assign).mean() for g, w in zip(got, want)])
    assert same >= 0.95, same
    _, gti = jgt.exact_knn(q, x, K)
    recall = []
    for gs, ret, scores in ((got, tret, tbase.bliss_scores), (want, jret, jbase.bliss_scores)):
        ptks = [ret.partition_topk(g.store, q, K) for g in gs]
        m = [ret.probe_topn(np.asarray(scores(g, q)), 3) for g in gs]
        res = ret.merge_groups(ptks, m, gti, K, [g.assign for g in gs], len(x))
        recall.append(res.recall)
        assert res.cmp_mean <= len(x)
    assert abs(recall[0] - recall[1]) <= 0.05, recall
    assert recall[0] > 0.3


def test_baselines_from_a_generator(data):
    """The generator-drawn starts the port uses outside the parity tests."""
    x, q = data[0][:1024], data[1]
    gen = torch.Generator().manual_seed(0)
    assert tpart.store_stats(tbase.build_ivf(x, 8, n_iters=3, generator=gen, device="cpu"))[
        "total"] == 1024
    idx = tbase.build_ivfpq(x, 8, m=4, ks=16, n_iters=3, generator=gen, device="cpu")
    assert idx.codes.shape == (1024, 4) and idx.codes.dtype == np.uint8
    groups = tbase.build_bliss(x, 8, n_groups=1, reparts=1, epochs=1, hidden=16,
                               generator=gen, device="cpu")
    assert tbase.bliss_scores(groups[0], q).shape == (len(q), 8)
    with pytest.raises(ValueError, match="generator"):
        tbase.build_ivf(x, 8, device="cpu")
