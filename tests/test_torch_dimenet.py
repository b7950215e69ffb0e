"""The port's DimeNet (``repro_torch.models.dimenet``), ``data/graph.py``,
``make_geometric_graph``, ``build_triplets`` and the graph smoke inputs
against the JAX package on the CPU: the SMOKE config at both SMOKE shapes,
one JAX ``init_params`` tree carried into the port by ``from_jax_params``,
the batch of each package's ``build_graph_batch`` (equal byte for byte). The
JAX side of each shape runs once (``_jax``).

Tolerances: the envelope equal, the radial basis within 1e-6 and the
spherical within 1e-5 (``test_bases_match_jax`` says why); the forward's node predictions within
1e-5; one train step's loss, grad_norm and updated state within 5e-5 (AdamW
eps 1e-3, as ``test_torch_recsys.py``). Remat none and full give the same
bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.data import graph as jgraph
from repro.data import synthetic as jsyn
from repro.data.smoke import make_smoke_inputs as jax_smoke_inputs
from repro.models import build_bundle as jax_build_bundle
from repro.models import dimenet as jdn
from repro.train import optimizer as jopt
from repro.utils.compat import make_mesh
from repro_torch.configs import get_smoke
from repro_torch.data import graph as tgraph
from repro_torch.data import synthetic as tsyn
from repro_torch.data.smoke import make_smoke_inputs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle
from repro_torch.models import dimenet as tdn
from repro_torch.models.api import ShapeSpec, TrainState, adamw

SHAPES = {s.name: s for s in get_smoke("dimenet")[1]}
FWD_ATOL = 1e-5
TRAIN_ATOL = 5e-5
LR, EPS = 1e-2, 1e-3
JMESH = make_mesh((1, 1), ("data", "model"))
TMESH = make_test_mesh(device="cpu")
_MEMO: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these models are tiny, and beside other test
    workers a pool of spinning threads makes their steps far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dims(shape):
    return shape["n_nodes"] * shape.dims.get("batch", 1), shape["d_feat"]


def _jax(name) -> dict:
    """The JAX side of SMOKE shape ``name``, once: params, the smoke batch,
    the forward's predictions and one train step."""
    if name in _MEMO:
        return _MEMO[name]
    shape = SHAPES[name]
    jcfg = jax_get_smoke("dimenet")[0]
    n_nodes, d_feat = _dims(shape)
    params = jdn.init_params(jax.random.PRNGKey(0), jcfg, d_feat)
    batch = jax_smoke_inputs(jcfg, JaxShapeSpec(shape.name, shape.kind, dict(shape.dims)), JMESH,
                             seed=0)["batch"]
    jtx = jopt.adamw(LR, eps=EPS)
    with JMESH:
        pred = np.asarray(jax.jit(lambda p, b: jdn.forward(p, b, jcfg, JMESH, n_nodes=n_nodes,
                                                           d_feat=d_feat))(params, batch))
        (p1, o1), m = jax.jit(jdn.make_train_step(jcfg, JMESH, jtx, n_nodes=n_nodes,
                                                  d_feat=d_feat))((params, jtx.init(params)), batch)
    _MEMO[name] = out = {
        "np": jax.tree.map(np.asarray, params), "batch": batch, "pred": pred,
        "metrics": {k: float(v) for k, v in m.items()},
        "state": [np.asarray(x) for x in jax.tree.leaves((p1, o1))]}
    return out


def _port(name, remat="full"):
    cfg = dataclasses.replace(get_smoke("dimenet")[0], remat=remat)
    shape = SHAPES[name]
    model = tdn.from_jax_params(_jax(name)["np"], cfg, shape["d_feat"], "cpu")
    return cfg, shape, model, make_smoke_inputs(cfg, shape, TMESH, seed=0)["batch"]


def test_bases_match_jax():
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.uniform(0, 6, 500), [0.0, 1e-7, 5.0, 4.999]]).astype(np.float32)
    angle = rng.uniform(0, np.pi, d.size).astype(np.float32)
    td, ta = torch.from_numpy(d), torch.from_numpy(angle)
    # the envelope's integer powers are XLA's products (equal bits); sin and
    # cos differ from XLA's in the last bit; arccos near ±1 turns a last-bit
    # difference of cos θ into ~1e-5 of θ (3.8e-5 here), the basis 5e-6
    pairs = [
        (jdn.envelope(jnp.asarray(d), 5.0), tdn.envelope(td, 5.0), 0.0),
        (jdn.radial_basis(jnp.asarray(d), 6), tdn.radial_basis(td, 6), 1e-6),
        (jdn.spherical_basis(jnp.asarray(angle), jnp.asarray(d), 7, 6),
         tdn.spherical_basis(ta, td, 7, 6), 1e-5),
    ]
    for j, t, atol in pairs:
        assert tuple(j.shape) == tuple(t.shape)
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=atol)
    assert float(tdn.envelope(torch.tensor([5.0, 6.0]), 5.0).abs().max()) == 0.0


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_matches_jax(name):
    cfg, shape, model, batch = _port(name)
    n_nodes, d_feat = _dims(shape)
    with torch.no_grad():
        pred = tdn.forward(model, batch, n_nodes=n_nodes, d_feat=d_feat)
    assert pred.shape == (n_nodes,)
    np.testing.assert_allclose(_np(pred), _jax(name)["pred"], rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("name", list(SHAPES))
def test_train_step_matches_jax(name):
    cfg, shape, model, batch = _port(name)
    state = TrainState(model, adamw(model, LR, eps=EPS))
    state, m = build_bundle(cfg, TMESH).step(shape).fn(state, batch)
    jm = _jax(name)["metrics"]
    assert set(m) == set(jm) == {"loss", "grad_norm"}
    for k in jm:
        assert abs(float(m[k]) - jm[k]) <= TRAIN_ATOL, (k, float(m[k]), jm[k])
    jleaves = _jax(name)["state"]
    assert len(jleaves) == len(state.leaves())
    for n, j, t in zip(state.leaf_names(), jleaves, state.leaves()):
        assert j.shape == tuple(t.shape), n
        assert np.abs(j.astype(np.float64) - _np(t)).max() <= TRAIN_ATOL, n
    if shape["d_feat"] > 0:             # the embedding is unused under features: zero moments
        i = state.leaf_names().index("opt/mu/atom_embed")
        assert bool((state.leaves()[i] == 0).all())


@pytest.mark.parametrize("name", list(SHAPES))
def test_remat_none_equals_full_bit_for_bit(name):
    """Two steps of the bundle's own optimizer: remat none and full end in
    the same metrics and state, bit for bit."""
    ends = {}
    for remat in ("none", "full"):
        cfg, shape, model, batch = _port(name, remat)
        bundle = build_bundle(cfg, TMESH)
        state = TrainState(model, bundle.optimizer(model))
        for _ in range(2):
            state, m = bundle.step(shape).fn(state, batch)
        ends[remat] = [float(v) for v in m.values()], state.leaves()
    assert ends["none"][0] == ends["full"][0]
    assert all(torch.equal(a, b) for a, b in zip(ends["none"][1], ends["full"][1]))


@pytest.mark.parametrize("name", list(SHAPES))
def test_params_specs_bundle_and_smoke_inputs_match_jax(name):
    """from_jax_params -> to_jax_params is exact; the param and input specs
    are the reference's; the smoke batch is the reference's bytes; init
    draws std 1/sqrt(fan_in); the optimizer follows the reference's
    schedule; another kind raises, and so does a step over 5 ranks, which do
    not split the batch's edges."""
    cfg, shape, model, batch = _port(name)
    jcfg = jax_get_smoke("dimenet")[0]
    pnp = _jax(name)["np"]
    back = tdn.to_jax_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(pnp)
    for a, b in zip(jax.tree.leaves(pnp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    jshape = JaxShapeSpec(shape.name, shape.kind, dict(shape.dims))
    jb, tb = jax_build_bundle(jcfg, JMESH), build_bundle(cfg, TMESH)
    assert jax.tree.map(lambda s: tuple(s.shape), jb.param_specs(jshape)) == \
        jax.tree.map(lambda s: tuple(s.shape), tb.param_specs(shape))
    assert {n: (tuple(s.shape), np.dtype(s.dtype).name)
            for n, s in jb.step(jshape).input_specs.items()} == \
        {n: (tuple(s.shape), str(s.dtype).removeprefix("torch."))
         for n, s in tb.step(shape).input_specs.items()}
    jbatch = _jax(name)["batch"]
    assert set(jbatch) == set(batch)
    for k in jbatch:
        np.testing.assert_array_equal(np.asarray(jbatch[k]), _np(batch[k]))
    drawn = tb.init(torch.Generator().manual_seed(0), shape)
    w = drawn["blocks.w_bil"].detach()
    assert drawn.device.type == "cpu" and abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1) < 0.1
    assert tuple(drawn["node_proj"].shape) == (shape["d_feat"] or 16, cfg.d_hidden)
    tx = tb.optimizer(drawn)
    sched = jopt.cosine_schedule(1e-3, 100, 10_000)
    assert all(tx.lr_fn(s) == pytest.approx(float(sched(s)), rel=1e-6) for s in (1, 100, 5_000))
    with pytest.raises(ValueError, match="shape kind"):
        tb.step(ShapeSpec("x", "rec_train", {"batch": 1}))
    step5 = build_bundle(cfg, make_test_mesh(5, 1, device="cpu")).step(shape)
    with pytest.raises(ValueError, match="do not split over 5 ranks"):
        step5.fn(TrainState(drawn, tb.optimizer(drawn)), batch)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_graph_data_functions_match_jax(seed):
    """make_geometric_graph, build_triplets (with and without a cap),
    build_graph_batch at 1 and 4 shards and NeighborSampler give the
    reference's bytes."""
    def same(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()

    for n, deg, d in ((40, 3, 2), (65, 5, 0)):
        for x, y in zip(jsyn.make_geometric_graph(np.random.default_rng(seed), n, deg, d),
                        tsyn.make_geometric_graph(np.random.default_rng(seed), n, deg, d)):
            same(x, y)
    _, _, ei = tsyn.make_geometric_graph(np.random.default_rng(seed), 50, 4, 1)
    for cap in (None, 100):
        for x, y in zip(jsyn.build_triplets(ei, cap, seed), tsyn.build_triplets(ei, cap, seed)):
            same(x, y)
    for kw in (dict(n_nodes=12, n_edges=32, d_feat=0, triplet_mult=4, n_graphs=4),
               dict(n_nodes=70, n_edges=200, d_feat=5, triplet_mult=2)):
        for n_shards in (1, 4):
            j = jgraph.build_graph_batch(seed, n_shards=n_shards, **kw)
            t = tgraph.build_graph_batch(seed, n_shards=n_shards, **kw)
            assert set(j) == set(t)
            for k in j:
                same(j[k], t[k])
    js = jgraph.NeighborSampler(50, ei, fanout=(4, 3), seed=seed)
    ts = tgraph.NeighborSampler(50, ei, fanout=(4, 3), seed=seed)
    for step in (0, 5):
        for x, y in zip(js.sample(step, 6), ts.sample(step, 6)):
            same(np.asarray(x), np.asarray(y))
