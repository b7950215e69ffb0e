"""The port's training substrate against the JAX reference, on the CPU:
``CheckpointManager`` (round trip, GC at ``keep``, partial writes ignored:
``tests/test_substrate.py:70-90``), checkpoints written by one package and
restored by the other (bfloat16 leaves too), ``ProbingPipeline`` batches
(bit for bit), and the ``Trainer``'s crash-and-restart contract
(``tests/test_substrate.py:101-117``): a run that fails after an update and
restarts from its last checkpoint ends bit-equal to an uninterrupted run.

A probing-model run that the JAX Trainer starts and the port's Trainer
resumes from the JAX checkpoint is held against a JAX run of all its steps,
from the same initial parameters (``probing.params_from_jax``) and batches:
rtol 1e-4, atol 1e-5 on every parameter and moment, as
``tests/test_torch_build.py`` holds several optimizer steps (Adam's
normalization amplifies last-bit differences of the gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.core import probing as jprobing
from repro.data.pipeline import PipelineSpec as JaxPipelineSpec
from repro.data.pipeline import ProbingPipeline as JaxProbingPipeline
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.ckpt.checkpoint import CheckpointManager, load_leaves, read_manifest
from repro_torch.core import probing as tprobing
from repro_torch.core.train_probing import make_train_step, state_leaf_names, train_state
from repro_torch.data.pipeline import PipelineSpec, ProbingPipeline
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer

CFG = dict(dim=16, n_partitions=8, q_hidden=(32, 16), i_hidden=(16,), p_hidden=(32,))


@pytest.fixture(scope="module")
def probe_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 16)).astype(np.float32)
    cd = rng.random((600, 8)).astype(np.float32) * 50
    lab = (rng.random((600, 8)) < 0.3).astype(np.float32)
    params = jax.tree.map(np.array, jprobing.init(jax.random.PRNGKey(2),
                                                  jprobing.ProbingConfig(**CFG)))
    return x, cd, lab, params


def port_trainer(params, pipeline, ckpt=None, **kw):
    model = tprobing.params_from_jax(params, device="cpu")
    tx = topt.AdamW(model.parameters(), topt.cosine_schedule(2e-3, 5, 60))
    return Trainer(make_train_step(model, tx), train_state(model, tx), pipeline,
                   ckpt_manager=ckpt, **kw)


def jax_trainer(params, pipeline, ckpt=None, **kw):
    tx = jopt.adamw(jopt.cosine_schedule(2e-3, 5, 60))

    def step_fn(state, batch):
        p, s = state
        loss, grads = jax.value_and_grad(jprobing.bce_loss)(
            p, batch["q"], batch["cent_dist"], batch["labels"])
        grads, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        updates, s = tx.update(grads, s, p)
        return (jopt.apply_updates(p, updates), s), {"loss": loss, "grad_norm": gnorm}

    p = jax.tree.map(jnp.asarray, params)
    return JaxTrainer(step_fn, (p, tx.init(p)), pipeline, ckpt_manager=ckpt, **kw)


# ------------------------------------------------------------ checkpoints

def test_checkpoint_roundtrip_and_gc(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    leaves = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
              torch.ones(4, dtype=torch.int32), torch.tensor(7, dtype=torch.int32)]
    cm.save(10, leaves, extra={"note": "x"})
    cm.save(20, leaves)
    cm.save(30, [leaves[0].T] + leaves[1:], extra={"note": "y"})
    assert cm.all_steps() == [20, 30]            # keep=2 collected step 10
    template = [torch.zeros(3, 2), torch.zeros(4, dtype=torch.int32),
                torch.zeros((), dtype=torch.int32)]
    restored, step, extra = cm.restore(template)
    assert step == 30 and extra == {"note": "y"}
    for got, want, t in zip(restored, [leaves[0].T] + leaves[1:], template):
        assert got.dtype == t.dtype and got.shape == t.shape
        assert torch.equal(got, want)
    restored, step, extra = cm.restore([torch.zeros(2, 3)] + template[1:], step=20)
    assert step == 20 and extra == {} and torch.equal(restored[0], leaves[0])
    with pytest.raises(ValueError, match="template"):
        cm.restore(template[:2])
    with pytest.raises(ValueError, match="leaf 0"):
        cm.restore([torch.zeros(2, 3)] + template[1:])


def test_checkpoint_restore_into_numpy_and_nothing_saved(tmp_path):
    cm = CheckpointManager(tmp_path / "empty")
    assert cm.restore([np.zeros(3)]) == (None, None, None)
    assert cm.latest_step() is None and cm.all_steps() == []
    cm.save(3, [np.arange(3, dtype=np.int64)])
    (got,), step, _ = cm.restore([np.zeros(3, np.float32)])
    assert step == 3 and got.dtype == np.float32 and (got == [0, 1, 2]).all()


def test_checkpoint_ignores_partial_writes(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, [torch.ones(3)])
    # a crash mid-save: an orphan tmp dir and a step dir without a manifest
    (tmp_path / "step_0000000002.tmp").mkdir()
    (tmp_path / "step_0000000003").mkdir()
    assert cm.latest_step() == 1
    assert cm.restore([torch.zeros(3)])[1] == 1


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path, probe_data):
    """The reference saves (params, OptState); the port's ``train_state``
    lists the same leaves in the same order and layout, so each package
    restores the other's directory."""
    params = probe_data[3]
    tx = jopt.adamw(1e-3)
    jstate = (jax.tree.map(jnp.asarray, params), tx.init(params))
    jstate = (jstate[0], jstate[1]._replace(step=jnp.asarray(5, jnp.int32),
                                            mu=jax.tree.map(lambda a: a + 1.0, jstate[0])))
    JaxCheckpointManager(tmp_path / "j").save(5, jstate, extra={"history": [{"step": 5}]})

    model = tprobing.ProbingModel(tprobing.ProbingConfig(**CFG), device="cpu")
    ttx = topt.AdamW(model.parameters())
    state = train_state(model, ttx)
    assert len(state) == len(jax.tree.leaves(jstate)) == len(state_leaf_names(model))
    restored, step, extra = CheckpointManager(tmp_path / "j").restore(state)
    assert step == 5 and extra["history"] == [{"step": 5}]
    for got, want in zip(restored, jax.tree.leaves(jstate)):
        assert got.dtype == torch.from_numpy(np.array(want)).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with torch.no_grad():
        for dst, src in zip(state, restored):
            dst.copy_(src)
    assert ttx.step == 5
    np.testing.assert_array_equal(model.phi_q[0].weight.detach().numpy().T, params["phi_q"][0]["w"])
    np.testing.assert_array_equal(ttx.mu[1].numpy(), params["phi_q"][0]["b"] + 1.0)

    CheckpointManager(tmp_path / "t").save(7, state, extra={"history": []})
    back, step, _ = JaxCheckpointManager(tmp_path / "t").restore(jstate)
    assert step == 7
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _bf16_values(shape, seed):
    """bfloat16 values with every exponent range, subnormals, ±0 and ±inf."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x = x * np.float32(2.0) ** np.random.default_rng(seed + 1).integers(-130, 120, shape)
    x.reshape(-1)[:4] = [0.0, -0.0, np.inf, -np.inf]
    return torch.from_numpy(x).to(torch.bfloat16)


def test_bf16_checkpoint_round_trip_is_exact(tmp_path):
    """The port writes a bfloat16 tensor upcast to f32 (npy has no bf16) and
    restores it into a bfloat16 template bit for bit."""
    t = _bf16_values((5, 7), 0)
    cm = CheckpointManager(tmp_path)
    cm.save(1, [t, torch.arange(3)])
    _, meta = read_manifest(tmp_path)
    assert meta["dtypes"] == ["float32", "int64"]
    (got, ints), step, _ = cm.restore([torch.zeros(5, 7, dtype=torch.bfloat16),
                                       torch.zeros(3, dtype=torch.int64)])
    assert step == 1 and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    assert torch.equal(ints, torch.arange(3))


def test_bf16_checkpoints_cross_between_the_packages(tmp_path):
    """The reference writes a bfloat16 leaf as 2-byte records beside the
    manifest dtype "bfloat16": the port reads its bits (as f32 from
    ``load_leaves``, as bfloat16 into a bfloat16 template). A port
    checkpoint of bfloat16 tensors restores in the reference (which casts
    the f32 file to its template's bfloat16)."""
    t = _bf16_values((4, 6), 2)
    j = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    JaxCheckpointManager(tmp_path / "j").save(3, {"a": j, "b": jnp.arange(2)})
    step_dir, meta = read_manifest(tmp_path / "j")
    assert meta["dtypes"][0] == "bfloat16"
    raw = np.load(step_dir / "leaf_00000.p0.npy")
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
    f32, _ = load_leaves(step_dir, meta)
    assert f32.dtype == np.float32
    np.testing.assert_array_equal(f32, t.float().numpy())
    (got, b), step, _ = CheckpointManager(tmp_path / "j").restore(
        [torch.zeros(4, 6, dtype=torch.bfloat16), torch.zeros(2, dtype=torch.int32)])
    assert step == 3 and torch.equal(got.view(torch.int16), t.view(torch.int16))
    assert b.tolist() == [0, 1]

    CheckpointManager(tmp_path / "t").save(4, [t, torch.arange(2, dtype=torch.int32)])
    back, step, _ = JaxCheckpointManager(tmp_path / "t").restore(
        {"a": jnp.zeros((4, 6), jnp.bfloat16), "b": jnp.zeros(2, jnp.int32)})
    assert step == 4 and back["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["a"]).view(np.uint16),
                                  np.asarray(j).view(np.uint16))


# ------------------------------------------------------------ pipeline

@pytest.mark.parametrize("spec", [dict(global_batch=64, seed=0),
                                  dict(global_batch=64, seed=3, n_hosts=2, host_id=1)])
def test_probing_pipeline_batches_equal_jax(probe_data, spec):
    x, cd, lab, _ = probe_data
    tp = ProbingPipeline(PipelineSpec(**spec), x, cd, lab)
    jp = JaxProbingPipeline(JaxPipelineSpec(**spec), x, cd, lab)
    for step in (0, 1, 17, 600):
        got, want = tp.batch_at(step), jp.batch_at(step)
        assert got.keys() == want.keys()
        for name in got:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
    assert not np.array_equal(tp.batch_at(0)["q"], tp.batch_at(1)["q"])
    assert tp.spec.host_batch == 64 // spec.get("n_hosts", 1)
    with pytest.raises(ValueError, match="split"):
        PipelineSpec(global_batch=63, n_hosts=2).host_batch


# ------------------------------------------------------------ trainer

class _ConstPipeline:
    def batch_at(self, step):
        return {"x": np.zeros(1, np.float32)}


def _quadratic_problem():
    """min ||w - target||², with a step function that returns new tensors."""
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32))

    def step_fn(state, batch):
        w, m, v, t = state
        w = w.detach().requires_grad_(True)
        loss = ((w - target) ** 2).sum()
        (g,) = torch.autograd.grad(loss, [w])
        t = t + 1
        m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g * g
        w = w.detach() - 0.1 * (m / (1 - 0.9 ** float(t))) / (
            torch.sqrt(v / (1 - 0.999 ** float(t))) + 1e-8)
        return [w, m, v, t], {"loss": loss.detach()}

    def state0():
        return [torch.zeros(8, 4), torch.zeros(8, 4), torch.zeros(8, 4),
                torch.zeros((), dtype=torch.int32)]
    return step_fn, state0, target


def test_trainer_crash_restart_is_exact(tmp_path):
    step_fn, state0, target = _quadratic_problem()
    gold, _ = Trainer(step_fn, state0(), _ConstPipeline()).run(12)

    cm = CheckpointManager(tmp_path / "ck", keep=3)
    t1 = Trainer(step_fn, state0(), _ConstPipeline(), ckpt_manager=cm, ckpt_every=5)
    with pytest.raises(RuntimeError, match="simulated failure"):
        t1.run(12, fail_at=7)
    t2 = Trainer(step_fn, state0(), _ConstPipeline(), ckpt_manager=cm, ckpt_every=5)
    assert t2.start_step == 5
    state2, _ = t2.run(12)
    for a, b in zip(gold, state2):
        assert torch.equal(a, b)
    long, _ = Trainer(step_fn, state0(), _ConstPipeline()).run(300)
    torch.testing.assert_close(long[0], target, atol=1e-2, rtol=0)


def test_probing_trainer_crash_restart_is_exact(tmp_path, probe_data):
    """The probing model trained in place through ``make_train_step``: a
    crash after step 25's update, restarted from step 20's checkpoint, ends
    bit-equal to an uninterrupted 40 steps, history included."""
    x, cd, lab, params = probe_data
    pipe = ProbingPipeline(PipelineSpec(global_batch=64, seed=1), x, cd, lab)
    gold_state, gold_hist = port_trainer(params, pipe, log_every=5).run(40)

    cm = CheckpointManager(tmp_path / "ck", keep=2)
    t1 = port_trainer(params, pipe, cm, ckpt_every=10, log_every=5)
    with pytest.raises(RuntimeError, match="simulated failure at step 25"):
        t1.run(40, fail_at=25)
    t2 = port_trainer(params, pipe, cm, ckpt_every=10, log_every=5)
    assert t2.start_step == 20 and cm.all_steps() == [10, 20]
    state, hist = t2.run(40)
    for a, b in zip(gold_state, state):
        assert torch.equal(a, b)
    assert [h["loss"] for h in hist] == [h["loss"] for h in gold_hist]
    assert [h["step"] for h in hist] == list(range(5, 45, 5))


def test_port_trainer_resumes_a_jax_probing_run(tmp_path, probe_data):
    """JAX trains 30 steps and checkpoints; the port's Trainer resumes from
    that directory to step 60; a JAX run of all 60 steps is the reference."""
    x, cd, lab, params = probe_data
    jpipe = JaxProbingPipeline(JaxPipelineSpec(global_batch=64, seed=1), x, cd, lab)
    tpipe = ProbingPipeline(PipelineSpec(global_batch=64, seed=1), x, cd, lab)
    (jp, js), _ = jax_trainer(params, jpipe).run(60)
    want = jax.tree.leaves((jp, js))

    jax_trainer(params, jpipe, JaxCheckpointManager(tmp_path / "ck"), ckpt_every=30).run(30)
    t = port_trainer(params, tpipe, CheckpointManager(tmp_path / "ck"), ckpt_every=30)
    assert t.start_step == 30
    state, _ = t.run(60)
    names = state_leaf_names(tprobing.params_from_jax(params, device="cpu"))
    for name, got, w in zip(names, state, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
