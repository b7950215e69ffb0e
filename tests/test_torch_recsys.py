"""The port's recsys family (``repro_torch.models.recsys``: DeepFM, AutoInt,
MIND, DLRM-RM2), ``RecsysPipeline``, ``make_recsys_batch`` and the recsys
smoke inputs against the JAX package on the CPU. The SMOKE configs; one JAX
``init_params`` tree carried into the port by ``from_jax_params``; numpy
inputs from one seed (each package's ``make_smoke_inputs``, equal byte for
byte). The JAX side of each architecture runs once (``_jax``) and the port's
cases are held against it.

Tolerances: serve scores within 1e-5; retrieval ids equal up to ties (where
the ids differ, the port's id has the JAX score of that rank within 1e-5);
one train step's loss, grad_norm and updated state within 5e-5, under
AdamW with eps 1e-3 (at 1e-8 an element whose gradient is within a few eps
of zero turns a last-bit difference of the gradient into an update of up to
lr: ``test_torch_lm_train.py``'s docstring).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.data.pipeline import PipelineSpec as JaxPipelineSpec
from repro.data.pipeline import RecsysPipeline as JaxRecsysPipeline
from repro.data.smoke import make_smoke_inputs as jax_smoke_inputs
from repro.data.synthetic import make_recsys_batch as jax_make_recsys_batch
from repro.models import build_bundle as jax_build_bundle
from repro.models import recsys as jrs
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JaxTrainer
from repro.utils.compat import make_mesh
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import PipelineSpec, RecsysPipeline
from repro_torch.data.smoke import make_smoke_inputs
from repro_torch.data.synthetic import make_recsys_batch
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle
from repro_torch.models import recsys as trs
from repro_torch.models.api import ShapeSpec, TrainState, adamw
from repro_torch.train.trainer import Trainer

ARCHS = ("deepfm", "autoint", "mind", "dlrm-rm2")
SERVE_ATOL = 1e-5
TRAIN_ATOL = 5e-5
LR, EPS = 1e-2, 1e-3
RETRIEVAL = ShapeSpec("retrieval_sm", "retrieval", {"batch": 1, "n_candidates": 512})
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


def _jshape(shape: ShapeSpec) -> JaxShapeSpec:
    return JaxShapeSpec(shape.name, shape.kind, dict(shape.dims))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _inputs(arch, shape, seed):
    """Each package's smoke batch for ``shape``: (jax, port, numpy)."""
    jcfg, tcfg = jax_get_smoke(arch)[0], get_smoke(arch)[0]
    jb = jax_smoke_inputs(jcfg, _jshape(shape), JMESH, seed=seed)["batch"]
    tb = make_smoke_inputs(tcfg, shape, TMESH, seed=seed)["batch"]
    return jb, tb, {k: _np(v) for k, v in tb.items()}


class _SmokePipeline:
    """Batches of the recsys smoke inputs, seeded by the step: they carry
    MIND's history, which ``RecsysPipeline`` (as the reference's) does not."""

    def __init__(self, arch, shape):
        self.arch, self.shape = arch, shape

    def batch_at(self, step: int) -> dict:
        return _inputs(self.arch, self.shape, 10 + step)[2]


def _jax(arch) -> dict:
    """The JAX side of ``arch``, once: params, serve scores, retrieval and
    one train step (and the step function, for the Trainer test)."""
    if arch in _MEMO:
        return _MEMO[arch]
    jcfg = jax_get_smoke(arch)[0]
    train, serve = get_smoke(arch)[1]
    params = jrs.init_params(jax.random.PRNGKey(0), jcfg)
    out = {"params": params, "np": jax.tree.map(np.asarray, params)}
    with JMESH:
        out["serve"] = np.asarray(jax.jit(jrs.make_serve_step(jcfg, JMESH, ("data",)))(
            params, _inputs(arch, serve, 1)[0]))
        rb = _inputs(arch, RETRIEVAL, 3)[0]
        out["scores"] = np.asarray(jax.jit(jrs.make_serve_step(jcfg, JMESH, ("data",)))(params, rb))
        vals, ids = jax.jit(jrs.make_serve_step(jcfg, JMESH, ("data",), topk=100))(params, rb)
        out["topk"] = np.asarray(vals), np.asarray(ids)
        jtx = jopt.adamw(LR, eps=EPS)
        step_fn = jrs.make_train_step(jcfg, JMESH, jtx, ("data",))
        (p1, o1), m = jax.jit(step_fn)((params, jtx.init(params)), _inputs(arch, train, 2)[0])
        out["train"] = ({k: float(v) for k, v in m.items()},
                        [np.asarray(x) for x in jax.tree.leaves((p1, o1))])
        out["step_fn"], out["tx"] = step_fn, jtx
    _MEMO[arch] = out
    return out


def _port(arch, device="cpu"):
    tcfg = get_smoke(arch)[0]
    return tcfg, trs.from_jax_params(_jax(arch)["np"], tcfg, device)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(arch):
    tcfg, model = _port(arch)
    serve = get_smoke(arch)[1][1]
    score = build_bundle(tcfg, TMESH).step(serve).fn(model, _inputs(arch, serve, 1)[1])
    assert score.shape == (serve["batch"],) and score.dtype == torch.float32
    np.testing.assert_allclose(_np(score), _jax(arch)["serve"], rtol=0, atol=SERVE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_matches_jax_up_to_ties(arch):
    """The top 100 of 512 candidates: values within 1e-5, ids equal up to
    ties."""
    tcfg, model = _port(arch)
    batch = _inputs(arch, RETRIEVAL, 3)[1]
    step = build_bundle(tcfg, TMESH).step(RETRIEVAL).fn
    vals, ids = step(model, batch)
    assert ids.dtype == torch.int32 and ids.shape == vals.shape == (100,)
    jv, ji = _jax(arch)["topk"]
    scores = _jax(arch)["scores"]
    np.testing.assert_allclose(_np(vals), jv, rtol=0, atol=SERVE_ATOL)
    ti = _np(ids)
    assert len(set(ti.tolist())) == 100
    differ = ti != ji
    assert np.all(np.abs(scores[ti[differ]] - jv[differ]) <= SERVE_ATOL), (ti[differ], ji[differ])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_in_chunks_equals_one_call(monkeypatch, arch):
    """Rows are independent: a serve step over chunks of 100 rows gives the
    scores of one call within 1e-6, and JAX's top 100 values."""
    tcfg, model = _port(arch)
    batch = _inputs(arch, RETRIEVAL, 3)[1]
    serve = trs.make_serve_step(tcfg, TMESH)
    whole = serve(model, batch)
    monkeypatch.setattr(trs, "SERVE_CHUNK", 100)
    chunked = trs.make_serve_step(tcfg, TMESH)(model, batch)
    np.testing.assert_allclose(_np(chunked), _np(whole), rtol=0, atol=1e-6)
    vals, ids = trs.make_serve_step(tcfg, TMESH, topk=100)(model, batch)
    np.testing.assert_allclose(_np(vals), _jax(arch)["topk"][0], rtol=0, atol=SERVE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One step from one tree: loss and grad_norm, and every leaf of
    (params, OptState) after it, in the reference's flatten order."""
    tcfg, model = _port(arch)
    train = get_smoke(arch)[1][0]
    state = TrainState(model, adamw(model, LR, eps=EPS))
    state, m = build_bundle(tcfg, TMESH).step(train).fn(state, _inputs(arch, train, 2)[1])
    jm, jleaves = _jax(arch)["train"]
    assert set(m) == set(jm) == {"loss", "grad_norm"}
    for k in jm:
        assert abs(float(m[k]) - jm[k]) <= TRAIN_ATOL, (k, float(m[k]), jm[k])
    leaves = state.leaves()
    names = state.leaf_names()
    assert len(leaves) == len(jleaves)
    for name, j, t in zip(names, jleaves, leaves):
        assert j.shape == tuple(t.shape), name
        assert np.abs(j.astype(np.float64) - _np(t)).max() <= TRAIN_ATOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_resumes_in_the_port(tmp_path, arch):
    """A JAX Trainer checkpointed at step 2 continues in the port's Trainer
    to step 3, within 5e-5 of the JAX Trainer's uninterrupted step 3."""
    j = _jax(arch)
    tcfg = get_smoke(arch)[0]
    pipe = _SmokePipeline(arch, get_smoke(arch)[1][0])
    with JMESH:
        JaxTrainer(j["step_fn"], (j["params"], j["tx"].init(j["params"])), pipe,
                   ckpt_manager=JaxCheckpointManager(tmp_path), ckpt_every=2,
                   log_every=1).run(2)
        gold, ghist = JaxTrainer(j["step_fn"], (j["params"], j["tx"].init(j["params"])), pipe,
                                 log_every=1).run(3)
    model = trs.from_jax_params(j["np"], tcfg, "cpu")
    trainer = Trainer(trs.make_train_step(tcfg, TMESH), TrainState(model, adamw(model, LR, eps=EPS)),
                      pipe, ckpt_manager=CheckpointManager(tmp_path), log_every=1)
    assert trainer.start_step == 2
    state, hist = trainer.run(3)
    assert abs(hist[-1]["loss"] - ghist[-1]["loss"]) <= TRAIN_ATOL
    for name, a, b in zip(state.leaf_names(), jax.tree.leaves(gold), state.leaves()):
        assert np.abs(np.asarray(a, np.float64) - _np(b)).max() <= TRAIN_ATOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_out_of_range_ids_add_zero_rows(arch):
    """Ids below 0 or at or past V: both packages give the same scores, and
    the port's bag holds a zero row for each such id."""
    jcfg, tcfg = jax_get_smoke(arch)[0], get_smoke(arch)[0]
    serve = get_smoke(arch)[1][1]
    jb, _, nb = _inputs(arch, serve, 4)
    v = tcfg.vocab_per_field
    bad = {"sparse_ids": np.array([-1, v, 3 * v, -v])}
    if tcfg.interaction == "multi-interest":
        bad = {"hist_ids": np.array([-1, v, 2 * v]), "target_id": np.array([v, -2])}
    for name, vals in bad.items():
        flat = nb[name].reshape(-1).copy()
        flat[::3] = np.resize(vals, len(flat[::3]))
        nb[name] = flat.reshape(nb[name].shape)
    with JMESH:
        js = np.asarray(jax.jit(jrs.make_serve_step(jcfg, JMESH, ("data",)))(
            _jax(arch)["params"], {k: jnp.asarray(a) for k, a in nb.items()}))
    _, model = _port(arch)
    ts = trs.make_serve_step(tcfg, TMESH)(model, {k: torch.from_numpy(a) for k, a in nb.items()})
    np.testing.assert_allclose(_np(ts), js, rtol=0, atol=SERVE_ATOL)
    ids = torch.tensor([[[-1] * tcfg.nnz, [v] * tcfg.nnz] + [[0] * tcfg.nnz] * (tcfg.n_sparse - 2)])
    with torch.no_grad():
        bag = trs.embedding_bag(model["tables"], ids[:, :tcfg.n_sparse])
        seq = trs.embedding_seq(model["tables"], torch.tensor([[-5, v, 0]]))
    if tcfg.n_sparse >= 2:
        assert bool((bag[0, :2] == 0).all()) and bool((bag[0, 2:] != 0).any())
    assert bool((seq[0, :2] == 0).all()) and bool((seq[0, 2] == model["tables"][0, 0]).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_specs_and_init(arch):
    """from_jax_params -> to_jax_params is exact; param_specs has the
    reference's shapes; a bundle's init draws zero biases, tables of std
    0.01 and weights of std 1/sqrt(fan_in)."""
    jcfg, tcfg = jax_get_smoke(arch)[0], get_smoke(arch)[0]
    pnp = _jax(arch)["np"]
    back = trs.to_jax_params(trs.from_jax_params(pnp, tcfg, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(pnp)
    for a, b in zip(jax.tree.leaves(pnp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    jspecs = jax.tree.map(lambda s: tuple(s.shape), jrs.param_specs(jcfg))
    tspecs = jax.tree.map(lambda s: tuple(s.shape), trs.param_specs(tcfg))
    assert jspecs == tspecs
    big = dataclasses.replace(tcfg, vocab_per_field=20_000)
    model = build_bundle(big, TMESH).init(torch.Generator().manual_seed(0))
    assert model.device.type == "cpu"
    assert abs(float(model["tables"].detach().std()) / 0.01 - 1) < 0.02
    for path, shape, (t,) in model.named_leaves():
        if path.endswith(".b"):
            assert bool((t == 0).all()), path
        elif path not in ("tables", "wide") and t.numel() >= 256:
            assert abs(float(t.detach().std()) * np.sqrt(shape[-2]) - 1) < 0.25, path
    with pytest.raises(ValueError, match="does not fit"):
        trs.from_jax_params(pnp, big, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_kinds_and_smoke_inputs_match_jax(arch):
    """Each kind's input specs are the reference's; the smoke inputs of each
    kind are the reference's bytes; the bundle's optimizer is the
    reference's schedule; another kind, or a mesh whose 3 model ranks do not
    split V = 128, raises."""
    jcfg, tcfg = jax_get_smoke(arch)[0], get_smoke(arch)[0]
    jb, tb = jax_build_bundle(jcfg, JMESH), build_bundle(tcfg, TMESH)
    for shape in (*get_smoke(arch)[1], RETRIEVAL):
        jspecs = {n: (tuple(s.shape), np.dtype(s.dtype).name)
                  for n, s in jb.step(_jshape(shape)).input_specs.items()}
        tspecs = {n: (tuple(s.shape), str(s.dtype).removeprefix("torch."))
                  for n, s in tb.step(shape).input_specs.items()}
        assert jspecs == tspecs, shape.name
        jin, tin, _ = _inputs(arch, shape, 5)
        assert set(jin) == set(tin) == set(tspecs)
        for name in jin:
            np.testing.assert_array_equal(np.asarray(jin[name]), _np(tin[name]))
    model = tb.init(torch.Generator().manual_seed(0))
    tx = tb.optimizer(model)
    sched = jopt.cosine_schedule(1e-3, 100, 100_000)
    for step in (1, 100, 5_000):
        assert tx.lr_fn(step) == pytest.approx(float(sched(step)), rel=1e-6)
    assert tx.weight_decay == 0.0 and len(tx.params) == len(list(model.parameters()))
    with pytest.raises(ValueError, match="shape kind"):
        tb.step(ShapeSpec("x", "train", {"batch": 1}))
    with pytest.raises(ValueError, match="vocab_per_field 128 does not split over 3"):
        build_bundle(tcfg, make_test_mesh(1, 3, device="cpu"))
    if tcfg.interaction == "multi-interest":
        with pytest.raises(RuntimeError, match="mind_forward"):
            trs.forward(model, tin)


def test_recsys_data_functions_match_jax():
    """make_recsys_batch and RecsysPipeline give the reference's bytes for
    several seeds, steps, hosts and configs."""
    for seed, (b, nd, ns, v, nnz) in enumerate(((8, 13, 26, 1000, 4), (5, 0, 39, 50, 1),
                                                (64, 4, 6, 128, 2))):
        j = jax_make_recsys_batch(np.random.default_rng(seed), b, nd, ns, v, multi_hot=nnz)
        t = make_recsys_batch(np.random.default_rng(seed), b, nd, ns, v, multi_hot=nnz)
        assert set(j) == set(t)
        for k in j:
            assert j[k].dtype == t[k].dtype and j[k].tobytes() == t[k].tobytes(), k
    for arch in ARCHS:
        cfg = get_smoke(arch)[0]
        for seed, step, host, n_hosts in ((0, 0, 0, 1), (3, 17, 1, 2), (7, 1000, 3, 4)):
            j = JaxRecsysPipeline(JaxPipelineSpec(8, seed, n_hosts, host), jax_get_smoke(arch)[0])
            t = RecsysPipeline(PipelineSpec(8, seed, n_hosts, host), cfg)
            jb, tb = j.batch_at(step), t.batch_at(step)
            assert set(jb) == set(tb) == ({"sparse_ids", "label"} | ({"dense"} if cfg.n_dense else set()))
            for k in jb:
                assert jb[k].dtype == tb[k].dtype and jb[k].tobytes() == tb[k].tobytes(), (arch, k)
