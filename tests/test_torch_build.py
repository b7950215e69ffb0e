"""The port's build path against the JAX reference, on the CPU, from the same
numpy inputs: probing model (via ``params_from_jax``), optimizer arithmetic,
Lloyd iterations from the same initial centroids, exact kNN, the padded
store, the redundancy plan, probe training from the same initial
parameters, and the end-to-end build's recall@10 at the ``small_dataset``
shape (``tests/conftest.py``).

Tolerances: f32 values computed in another summation order agree to
rtol/atol 1e-5 (1e-4 after several optimizer steps, whose Adam normalization
amplifies last-bit differences); discrete outputs (assignments, masks, kNN
ids, store layout, picks) must be equal except where the inputs tie within
that tolerance, which these seeds avoid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ground_truth as jgt
from repro.core import kmeans as jkm
from repro.core import probing as jprobing
from repro.core.partitions import build_store as jax_build_store
from repro.core.redundancy import plan_redundancy as jax_plan_redundancy
from repro.core.redundancy import replica_rows as jax_replica_rows
from repro.core.train_probing import train_probing_model as jax_train_probing_model
from repro.train import optimizer as jopt
from repro_torch.core import ground_truth as tgt
from repro_torch.core import kmeans as tkm
from repro_torch.core import probing as tprobing
from repro_torch.core.metrics import recall_at_k
from repro_torch.core.partitions import build_store as torch_build_store
from repro_torch.core.redundancy import plan_redundancy as torch_plan_redundancy
from repro_torch.core.redundancy import replica_rows as torch_replica_rows
from repro_torch.core.train_probing import train_probing_model as torch_train_probing_model
from repro_torch.data.synthetic import make_vector_dataset as torch_make_vector_dataset
from repro_torch.train import optimizer as topt


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    """Clustered points, their k-means partition and centroids (from JAX)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 8, 800)]
         + rng.normal(size=(800, 16)).astype(np.float32))
    q = (centers[rng.integers(0, 8, 64)]
         + rng.normal(size=(64, 16)).astype(np.float32))
    st = jkm.kmeans_fit(jax.random.PRNGKey(1), jnp.asarray(x), n_clusters=8, n_iters=8)
    return x, q, np.asarray(st.assign), np.asarray(st.centroids)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jprobing.ProbingConfig(dim=16, n_partitions=8, q_hidden=(32, 16),
                                 i_hidden=(16,), p_hidden=(32,))
    return np_tree(jprobing.init(jax.random.PRNGKey(2), cfg))


def test_synthetic_dataset_is_the_reference_copy():
    from repro.data.synthetic import make_vector_dataset as jax_make_vector_dataset

    a = jax_make_vector_dataset(n=500, n_queries=20, dim=8, n_modes=5, seed=7)
    b = torch_make_vector_dataset(n=500, n_queries=20, dim=8, n_modes=5, seed=7)
    np.testing.assert_array_equal(a.base, b.base)
    np.testing.assert_array_equal(a.queries, b.queries)


@pytest.mark.parametrize("sigma", [0.3, 0.5, 0.99])
def test_probing_logits_and_mask_match(data, jax_params, sigma):
    _, q, _, cents = data
    cd = np.array(jkm.centroid_distances(jnp.asarray(q), jnp.asarray(cents)))
    model = tprobing.params_from_jax(jax_params, device="cpu")
    qt, cdt = torch.from_numpy(q), torch.from_numpy(cd)
    with torch.no_grad():
        np.testing.assert_allclose(tkm.centroid_distances(qt, torch.from_numpy(cents)).numpy(),
                                   cd, rtol=1e-5, atol=1e-3)
        logits = model(qt, cdt).numpy()
        mask, p = model.predict_probe_mask(qt, cdt, sigma)
    np.testing.assert_allclose(logits, np.asarray(jprobing.apply(jax_params, q, cd)),
                               rtol=1e-5, atol=1e-5)
    jmask, jp = jprobing.predict_probe_mask(jax_params, q, cd, sigma)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    near = np.abs(np.asarray(jp) - sigma) < 1e-5
    np.testing.assert_array_equal(mask.numpy()[~near], np.asarray(jmask)[~near])
    assert mask.sum(-1).min() >= 1  # the forced arg-max


def test_bce_loss_and_gradient_match(data, jax_params):
    _, q, _, cents = data
    cd = np.array(jkm.centroid_distances(jnp.asarray(q), jnp.asarray(cents)))
    labels = (np.random.default_rng(3).random((len(q), 8)) < 0.3).astype(np.float32)
    jl, jg = jax.value_and_grad(jprobing.bce_loss)(jax_params, q, cd, labels, pos_weight=2.0)
    model = tprobing.params_from_jax(jax_params, device="cpu")
    tl = tprobing.bce_loss(model, torch.from_numpy(q), torch.from_numpy(cd),
                           torch.from_numpy(labels), pos_weight=2.0)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jg = np_tree(jg)
    for name in ("phi_q", "phi_i", "phi_p"):
        for layer, g in zip(getattr(model, name), jg[name]):
            np.testing.assert_allclose(layer.weight.grad.numpy().T, g["w"], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(layer.bias.grad.numpy(), g["b"], rtol=1e-4, atol=1e-6)


def test_adamw_cosine_and_clip_match():
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    sched = jopt.cosine_schedule(1e-2, warmup=3, total=10)
    tsched = topt.cosine_schedule(1e-2, warmup=3, total=10)
    for s in (0, 1, 3, 6, 10, 20):
        assert abs(tsched(s) - float(sched(s))) <= 1e-9
    tx = jopt.adamw(sched, weight_decay=0.1)
    jstate = tx.init(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params["b"].copy()), torch.from_numpy(params["w"].copy())]
    ttx = topt.AdamW(tp, tsched, weight_decay=0.1)
    for _ in range(5):
        grads = {"w": rng.normal(size=(5, 3)).astype(np.float32) * 3,
                 "b": rng.normal(size=(3,)).astype(np.float32) * 3}
        jg, jn = jopt.clip_by_global_norm(grads, 1.0)
        tg, tn = topt.clip_by_global_norm([torch.from_numpy(grads["b"]),
                                           torch.from_numpy(grads["w"])], 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        upd, jstate = tx.update(jg, jstate, jp)
        jp = jopt.apply_updates(jp, upd)
        ttx.update(tg)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["b"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp["w"]), rtol=1e-5, atol=1e-6)


def test_lloyd_from_jax_init_matches_kmeans_fit(data):
    x = data[0]
    rng = jax.random.PRNGKey(5)
    init = np.asarray(jkm.plus_plus_init(rng, jnp.asarray(x), 8))
    jst = jkm.kmeans_fit(rng, jnp.asarray(x), n_clusters=8, n_iters=6)
    tst = tkm.lloyd(torch.from_numpy(x), torch.from_numpy(init), 6)
    ja, ta = np.asarray(jst.assign), tst.assign.numpy()
    d2 = np.asarray(jkm.centroid_distances(jnp.asarray(x), jst.centroids))
    srt = np.sort(d2, 1)
    tie = srt[:, 1] - srt[:, 0] < 1e-3
    np.testing.assert_array_equal(ta[~tie], ja[~tie])
    np.testing.assert_allclose(tst.centroids.numpy(), np.asarray(jst.centroids),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(tst.inertia), float(jst.inertia), rtol=1e-5)


def test_plus_plus_init_picks_data_points(data):
    x = torch.from_numpy(data[0])
    gen = torch.Generator().manual_seed(0)
    cents = tkm.plus_plus_init(x, 8, gen)
    hits = (cents[:, None, :] == x[None]).all(-1).any(-1)
    assert bool(hits.all()) and len(torch.unique(cents, dim=0)) == 8


def test_exact_knn_matches(data):
    x, q, _, _ = data
    jd, ji = jgt.exact_knn(q, x, 10, batch=32)
    td, ti = tgt.exact_knn(q, x, 10, batch=32, device="cpu")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("degenerate", [False, True])
def test_exclude_self_column_choice_matches(data, degenerate):
    """The vectorized self-match drop picks the reference loop's columns from
    the same k+1 neighbours. (Whether a self-match's expanded distance lands
    under 1e-9 is rounding noise, so each side is fed the JAX neighbours.)"""
    x = data[0][:60]
    if degenerate:  # duplicates: fewer than k neighbours at distance > 1e-9
        x = np.repeat(x[:5], 12, axis=0)
    jd, ji = jgt.exact_knn(x, x, 10, exclude_self=True)
    kd, ki = jgt.exact_knn(x, x, 11)
    td, ti = tgt.drop_self(kd, ki, 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    fd, fi = tgt.exact_knn(x, x, 10, exclude_self=True, device="cpu")
    assert fi.shape == (len(x), 10) and fd.dtype == np.float32


@pytest.mark.parametrize("capacity", [None, 60])
def test_build_store_matches(data, capacity):
    x, _, assign, cents = data
    ids = np.arange(len(x), dtype=np.int32)
    rng = np.random.default_rng(6)
    picked = rng.choice(len(x), 40, replace=False)
    extra = (x[picked], ids[picked], ((assign[picked] + 1) % 8).astype(np.int32))
    js = jax_build_store(x, ids, assign, cents, capacity=capacity, extra=extra)
    ts = torch_build_store(x, ids, assign, cents, capacity=capacity, extra=extra,
                           device="cpu")
    assert ts.capacity == js.capacity
    np.testing.assert_array_equal(ts.vectors.numpy(), np.asarray(js.vectors))
    np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    np.testing.assert_array_equal(ts.centroids.numpy(), np.asarray(js.centroids))


@pytest.mark.parametrize("eta", [0.05, 0.2])
def test_plan_redundancy_matches(data, jax_params, eta):
    x, _, assign, cents = data
    jp = jax_plan_redundancy(jax_params, x, assign, cents, eta=eta, batch=256)
    model = tprobing.params_from_jax(jax_params, device="cpu")
    tp = torch_plan_redundancy(model, x, assign, cents, eta=eta, batch=256)
    np.testing.assert_array_equal(tp.pred_nprobe, jp.pred_nprobe)
    np.testing.assert_array_equal(tp.picked, jp.picked)
    np.testing.assert_array_equal(tp.targets, jp.targets)
    ids = np.arange(len(x), dtype=np.int32)
    for a, b in zip(torch_replica_rows(tp, x, ids), jax_replica_rows(jp, x, ids)):
        np.testing.assert_array_equal(a, b)


def test_train_probing_from_same_init_matches(data, jax_params):
    x, _, assign, cents = data
    _, sti = jgt.exact_knn(x, x, 5, exclude_self=True)
    lab = np.zeros((len(x), 8), np.float32)
    lab[np.repeat(np.arange(len(x)), 5), assign[sti].reshape(-1)] = 1.0
    jparams, jlog = jax_train_probing_model(
        jax.random.PRNGKey(0), x, lab, cents, epochs=2, batch=128, eval_every=3,
        cfg=jprobing.ProbingConfig(dim=16, n_partitions=8, q_hidden=(32, 16),
                                   i_hidden=(16,), p_hidden=(32,)))
    # the reference draws its initial parameters from split(PRNGKey(0))[1]
    init = np_tree(jprobing.init(jax.random.split(jax.random.PRNGKey(0))[1],
                                 jprobing.ProbingConfig(dim=16, n_partitions=8,
                                                        q_hidden=(32, 16), i_hidden=(16,),
                                                        p_hidden=(32,))))
    model, tlog = torch_train_probing_model(x, lab, cents, epochs=2, batch=128, eval_every=3,
                                            model=tprobing.params_from_jax(init, device="cpu"))
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=1e-4)
    np.testing.assert_allclose(tlog.recalls, jlog.recalls, atol=1e-6)
    jparams = np_tree(jparams)
    for name in ("phi_q", "phi_i", "phi_p"):
        for layer, p in zip(getattr(model, name), jparams[name]):
            np.testing.assert_allclose(layer.weight.detach().numpy().T, p["w"],
                                       rtol=1e-4, atol=1e-5)


def test_end_to_end_build_recall_close_to_jax(small_dataset, monkeypatch):
    """The whole build on both sides at the ``small_dataset`` shape, from the
    same start: the port's k-means begins at the reference's k-means++
    centroids and its probing model at the reference's initial parameters
    (the random streams differ; build recall swings by ±0.15 across seeds on
    either side). Recall@10 within 0.02 at σ = 0.5 and 0.3."""
    from repro.launch.mesh import make_test_mesh
    from repro.serving.api import BuildConfig as JaxBuildConfig
    from repro.serving.engine import LiraEngine as JaxEngine
    from repro_torch.serving import engine as tengine
    from repro_torch.serving.api import BuildConfig

    ds = small_dataset
    kw = dict(n_partitions=16, k=10, epochs=8, impl="ref", seed=0)
    rng = jax.random.PRNGKey(0)
    init_cents = np.asarray(jkm.plus_plus_init(rng, jnp.asarray(ds.base), 16))
    init_params = np_tree(jprobing.init(jax.random.split(rng)[1],
                                        jprobing.ProbingConfig(dim=32, n_partitions=16)))
    monkeypatch.setattr(tengine, "kmeans_fit", lambda x, n_clusters, n_iters, generator:
                        tkm.lloyd(x, torch.from_numpy(init_cents), n_iters))
    monkeypatch.setattr(tengine, "train_probing_model", lambda *a, **k: torch_train_probing_model(
        *a, **{**k, "model": tprobing.params_from_jax(init_params, device="cpu")}))
    jeng = JaxEngine.build(make_test_mesh(), ds.base, JaxBuildConfig(**kw))
    teng = tengine.LiraEngine.build(ds.base, BuildConfig(**kw), device="cpu")
    _, gti = jgt.exact_knn(ds.queries, ds.base, 10)
    for sigma in (0.5, 0.3):
        jr = recall_at_k(jeng.search(ds.queries, sigma=sigma).ids, gti, 10)
        tr = recall_at_k(teng.search(ds.queries, sigma=sigma).ids, gti, 10)
        assert abs(jr - tr) <= 0.02, (sigma, jr, tr)
