"""The port's LM training path (``repro_torch.models.transformer``'s train
step, ``TrainState``, ``adamw``; ``train/optimizer.py``, ``utils/tree.py``,
``TokenPipeline`` and ``make_token_dataset``) against the JAX package on the
CPU. The SMOKE LM configs, one JAX ``init_params`` tree carried into the
port by ``from_jax_params``, ``TokenPipeline`` batches [4, 64], three steps
of each package's train step under AdamW (lr 1e-2, weight decay 0.1).

Compared: every step's loss, ce, moe_aux and grad_norm; every gradient of
the first step (the first moment after step 1 is 0.1 · the clipped
gradient, in both packages); every leaf of ``(params, OptState)`` after the
third step, in the reference's flatten order.

Tolerances:
  * f32: 5e-5 absolute on all of them. AdamW's eps is 1e-3 in these runs:
    at the default 1e-8 an element whose gradient is within a few eps of
    zero turns a last-bit difference of the gradient (~1e-7 here, the same
    sums in another order) into an update difference of up to lr — one or
    two elements of ~170,000 in three steps, in either package against a
    reordering of itself.
  * bf16: the metrics within 4 bf16 steps (2^-7 relative each) of the
    reference's value, as ``test_torch_transformer.py``'s rule; a gradient
    element within 4 bf16 steps of its leaf's largest |gradient|, all of
    them in the dense config and all but 1% in the MoE configs (a token
    whose router probabilities nearly tie can take another expert once its
    input moved by a bf16 step, and moves its gradient with it); a
    parameter after three steps within 4 bf16 steps of its leaf's largest
    |value|, all but 1% (dense) and 5% (MoE) of the elements: an element
    whose bf16 gradient is within its rounding of zero can take Adam's
    opposite step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.data.pipeline import PipelineSpec as JaxPipelineSpec
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.data.synthetic import make_token_dataset as jax_make_token_dataset
from repro.models import transformer as jtr
from repro.train import optimizer as jopt
from repro.utils import tree as jtree
from repro.utils.compat import make_mesh
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import PipelineSpec, TokenPipeline
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle
from repro_torch.models import transformer as ttr
from repro_torch.train import optimizer as topt
from repro_torch.utils import tree as ttree

F32_ATOL = 5e-5
BF16_STEPS = 4
LR, WD, EPS = 1e-2, 0.1, 1e-3
STEPS = 3
JMESH = make_mesh((1, 1), ("data", "model"))
TMESH = make_test_mesh(device="cpu")
DENSE, MOE, GQA = "stablelm-3b", "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"
# each knob varied alone around the SMOKE configs' defaults (remat full,
# logits_chunk 0, grad_accum 1)
CASES = {
    "dense": (DENSE, "float32", {}),
    "moe-remat-none": (MOE, "float32", {"remat": "none"}),
    "moe-remat-dots": (MOE, "float32", {"remat": "dots"}),
    "gqa-moe": (GQA, "float32", {}),
    "dense-logits-chunk-8": (DENSE, "float32", {"logits_chunk": 8}),
    "gqa-moe-grad-accum-4": (GQA, "float32", {"grad_accum": 4}),
    "dense-bf16": (DENSE, "bfloat16", {}),
    "moe-bf16": (MOE, "bfloat16", {}),
}
_MEMO: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these models are tiny, and beside other test
    workers on the machine a pool of spinning threads makes their steps
    tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **knobs):
    return (dataclasses.replace(jax_get_smoke(arch)[0], dtype=dtype, **knobs),
            dataclasses.replace(get_smoke(arch)[0], dtype=dtype, **knobs))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x


def _bf16_atol(ref) -> float:
    return BF16_STEPS * float(np.abs(ref).max()) * 2.0 ** -7


def _batch(vocab: int, step: int) -> dict:
    return TokenPipeline(PipelineSpec(global_batch=4), 64, vocab).batch_at(step)


def _run(case: str) -> dict:
    """Both packages' train steps, STEPS steps from one parameter tree."""
    if case in _MEMO:
        return _MEMO[case]
    arch, dtype, knobs = CASES[case]
    jcfg, tcfg = _cfgs(arch, dtype, **knobs)
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    jtx = jopt.adamw(LR, weight_decay=WD, eps=EPS)
    jstate = (params, jtx.init(params))
    step_fn = jtr.make_train_step(jcfg, JMESH, jtx)
    jstep = jax.jit(step_fn)
    model = ttr.from_jax_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    state = ttr.TrainState(model, ttr.adamw(model, LR, weight_decay=WD, eps=EPS))
    tstep = build_bundle(tcfg, TMESH).step(get_smoke(arch)[1][0]).fn
    out = {"jm": [], "tm": [], "names": state.leaf_names(), "dtype": dtype,
           "moe": tcfg.moe is not None, "step_fn": step_fn, "tx": jtx}
    for i in range(STEPS):
        b = _batch(tcfg.vocab, i)
        with JMESH:
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, tm = tstep(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out["jm"].append({k: float(v) for k, v in jm.items()})
        out["tm"].append({k: float(v) for k, v in tm.items()})
        if i == 0:
            # the first moment after one step is (1 - b1) · the clipped gradient
            out["grads"] = [(n, _np(j) / 0.1, _np(t) / 0.1) for n, j, t in zip(
                out["names"], jax.tree.leaves(jstate), state.leaves()) if n.startswith("opt/mu/")]
    out["final"] = list(zip(out["names"], [_np(x) for x in jax.tree.leaves(jstate)],
                            [_np(x) for x in state.leaves()]))
    _MEMO[case] = out
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    o = _run(case)
    for jm, tm in zip(o["jm"], o["tm"]):
        assert set(jm) == set(tm) == {"loss", "ce", "moe_aux", "grad_norm"}
        for k in jm:
            atol = F32_ATOL if o["dtype"] == "float32" else BF16_STEPS * abs(jm[k]) * 2.0 ** -7
            assert abs(jm[k] - tm[k]) <= atol, (k, jm[k], tm[k])
        assert np.isfinite(list(tm.values())).all()
        assert (tm["moe_aux"] > 0) == o["moe"]
    if o["dtype"] == "float32":
        for name, j, t in o["grads"] + o["final"]:
            assert j.shape == t.shape, name
            assert np.abs(j - t).max() <= F32_ATOL, (name, np.abs(j - t).max())
        return
    off = sum(int((np.abs(j - t) > _bf16_atol(j)).sum()) for _, j, t in o["grads"])
    size = sum(j.size for _, j, _ in o["grads"])
    assert off <= (0.01 * size if o["moe"] else 0), (off, size)
    params = [(j, t) for n, j, t in o["final"] if n.startswith("params/")]
    off = sum(int((np.abs(j - t) > _bf16_atol(j)).sum()) for j, t in params)
    size = sum(j.size for j, _ in params)
    assert off <= (0.05 if o["moe"] else 0.01) * size, (off, size)


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_remat_modes_give_the_same_bits(arch):
    """remat none, full and dots: two steps end in the same state, bit for
    bit (remat changes what is held for backward, not a value)."""
    ends = {}
    for remat in ("none", "full", "dots"):
        _, cfg = _cfgs(arch, "float32", remat=remat)
        bundle = build_bundle(cfg, TMESH)
        model = bundle.init(torch.Generator().manual_seed(0))
        state = ttr.TrainState(model, bundle.optimizer(model))
        step = bundle.step(get_smoke(arch)[1][0]).fn
        for i in range(2):
            batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, i).items()}
            state, m = step(state, batch)
        ends[remat] = ([float(v) for v in m.values()], state.leaves())
    for remat in ("full", "dots"):
        assert ends[remat][0] == ends["none"][0]
        assert all(torch.equal(a, b) for a, b in zip(ends[remat][1], ends["none"][1])), remat


def test_train_state_leaves_follow_the_jax_tree():
    """TrainState lists (params, OptState(step, mu, nu)) as jax.tree.flatten
    does, the layers stacked: the same names' shapes as the reference's
    leaves, and load_leaves puts a list back."""
    jcfg, tcfg = _cfgs(MOE)
    params = jtr.init_params(jax.random.PRNGKey(1), jcfg)
    jleaves = jax.tree.leaves((params, jopt.adamw(1e-3).init(params)))
    model = ttr.from_jax_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    state = ttr.TrainState(model, ttr.adamw(model, 1e-3))
    leaves = state.leaves()
    assert [tuple(np.shape(j)) for j in jleaves] == [tuple(t.shape) for t in leaves]
    names = state.leaf_names()
    assert names[:3] == ["params/embed", "params/layers.ln1", "params/layers.ln2"]
    assert names.index("params/ln_f") == names.index("params/unembed") - 1
    assert names[len(names) // 3] == "opt/step" and names[-1] == "opt/nu/unembed"
    for j, t in zip(jleaves[:len(jleaves) // 3], leaves):
        np.testing.assert_array_equal(_np(j), _np(t))
    shifted = [t + 1 for t in leaves]
    state.load_leaves(shifted)
    assert all(torch.equal(a, b) for a, b in zip(state.leaves(), shifted))
    assert torch.equal(model.layers[1]["wq"], shifted[names.index("params/layers.wq")][1])
    with pytest.raises(ValueError, match="leaves"):
        state.load_leaves(shifted[:-1])


def test_decay_mask_matches_jax():
    """The reference decays every leaf of rank ≥ 2 of its stacked tree:
    ln1 and ln2 ([L, D]) yes, ln_f ([D]) no. With zero gradients an AdamW
    step moves exactly the decayed parameters, by -lr·wd·p, in both."""
    jcfg, tcfg = _cfgs(DENSE)
    params = jtr.init_params(jax.random.PRNGKey(2), jcfg)
    jtx = jopt.adamw(0.5, weight_decay=0.2)
    zeros = jax.tree.map(jnp.zeros_like, params)
    updates, _ = jtx.update(zeros, jtx.init(params), params)
    moved = jax.tree.map(lambda u: bool((np.asarray(u) != 0).any()), updates)
    assert moved["layers"]["ln1"] and moved["layers"]["ln2"] and not moved["ln_f"]

    model = ttr.from_jax_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    tx = ttr.adamw(model, 0.5, weight_decay=0.2)
    mask = dict(zip(map(id, tx.params), tx.mask))
    for path, _, tensors in model.named_leaves():
        node = moved
        for part in path.split("."):
            node = node[part]
        assert all(mask[id(t)] == node for t in tensors), path
    tx.update([torch.zeros_like(p) for p in tx.params])
    back = ttr.to_jax_params(model)
    for a, u, b in zip(jax.tree.leaves(params), jax.tree.leaves(updates), jax.tree.leaves(back)):
        np.testing.assert_allclose(_np(a) + _np(u), b, rtol=0, atol=1e-7)
    assert (model.layers[0]["ln1"] != 1).all() and (model.ln_f == 1).all()
    # the default rule decides by the tensor held: a layer's ln1 is [D]
    assert not topt.AdamW([model.layers[0]["ln1"]]).mask[0]


def test_jax_checkpoint_resumes_in_the_port_and_back(tmp_path):
    """An f32 LM run checkpointed by the JAX Trainer at step 2 continues in
    the port's Trainer to step 4, and a port checkpoint at step 2 continues
    in the JAX Trainer: each ends within F32_ATOL of the other package's
    uninterrupted run."""
    from repro.ckpt import CheckpointManager as JaxCheckpointManager
    from repro.train.trainer import Trainer as JaxTrainer
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.train.trainer import Trainer

    jcfg, tcfg = _cfgs(DENSE)
    params = jtr.init_params(jax.random.PRNGKey(3), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    jtx, jstep = _run("dense")["tx"], _run("dense")["step_fn"]   # compiled once
    tstep = ttr.make_train_step(tcfg, TMESH)
    jpipe = JaxTokenPipeline(JaxPipelineSpec(global_batch=4), 64, tcfg.vocab)
    tpipe = TokenPipeline(PipelineSpec(global_batch=4), 64, tcfg.vocab)

    def jax_trainer(ckpt=None):
        return JaxTrainer(jstep, (params, jtx.init(params)), jpipe, ckpt_manager=ckpt,
                          ckpt_every=2, log_every=1)

    def port_trainer(ckpt=None):
        model = ttr.from_jax_params(params_np, tcfg, "cpu")
        state = ttr.TrainState(model, ttr.adamw(model, LR, weight_decay=WD, eps=EPS))
        return Trainer(tstep, state, tpipe, ckpt_manager=ckpt, ckpt_every=2, log_every=1)

    with JMESH:
        jgold, _ = jax_trainer().run(4)
        jax_trainer(JaxCheckpointManager(tmp_path / "j")).run(2)
        resumed = port_trainer(CheckpointManager(tmp_path / "j"))
        assert resumed.start_step == 2
        tstate, _ = resumed.run(4)
        for n, a, b in zip(tstate.leaf_names(), jax.tree.leaves(jgold), tstate.leaves()):
            assert np.abs(_np(a) - _np(b)).max() <= F32_ATOL, n

        tgold, _ = port_trainer().run(4)
        port_trainer(CheckpointManager(tmp_path / "t")).run(2)
        back = jax_trainer(JaxCheckpointManager(tmp_path / "t"))
        assert back.start_step == 2
        jstate, _ = back.run(4)
        for n, a, b in zip(tgold.leaf_names(), tgold.leaves(), jax.tree.leaves(jstate)):
            assert np.abs(_np(a) - _np(b)).max() <= F32_ATOL, n


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_port_crash_restart_is_exact(tmp_path, arch):
    """A bf16 LM Trainer that fails after step 3's update resumes from its
    step-2 checkpoint and ends equal, bit for bit, to an uninterrupted run."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.train.trainer import Trainer

    _, cfg = _cfgs(arch, "bfloat16")
    bundle = build_bundle(cfg, TMESH)
    step = bundle.step(get_smoke(arch)[1][0]).fn
    pipe = TokenPipeline(PipelineSpec(global_batch=4, seed=1), 64, cfg.vocab)

    def trainer(ckpt=None):
        model = bundle.init(torch.Generator().manual_seed(0))
        return Trainer(step, ttr.TrainState(model, bundle.optimizer(model)), pipe,
                       ckpt_manager=ckpt, ckpt_every=2, log_every=1)

    gold, hist = trainer().run(5)
    cm = CheckpointManager(tmp_path, keep=2)
    with pytest.raises(RuntimeError, match="simulated failure"):
        trainer(cm).run(5, fail_at=3)
    again = trainer(cm)
    assert again.start_step == 2
    state, hist2 = again.run(5)
    assert all(t.dtype == torch.bfloat16 for t in state.leaves()[:3])
    assert all(torch.equal(a, b) for a, b in zip(gold.leaves(), state.leaves()))
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist2]


# ------------------------------------------------------------ the substrate

def test_token_pipeline_and_dataset_match_jax():
    for seed, step, host, n_hosts in ((0, 0, 0, 1), (3, 17, 1, 2), (7, 1000, 3, 4)):
        j = JaxTokenPipeline(JaxPipelineSpec(8, seed, n_hosts, host), 32, 500).batch_at(step)
        t = TokenPipeline(PipelineSpec(8, seed, n_hosts, host), 32, 500).batch_at(step)
        for k in ("tokens", "labels"):
            assert j[k].dtype == t[k].dtype == np.int32
            np.testing.assert_array_equal(j[k], t[k])
    first = next(iter(TokenPipeline(PipelineSpec(2), 8, 50)))
    np.testing.assert_array_equal(first["tokens"], TokenPipeline(
        PipelineSpec(2), 8, 50).batch_at(0)["tokens"])
    for seed in (0, 5):
        np.testing.assert_array_equal(jax_make_token_dataset(10_000, 300, seed),
                                      make_token_dataset(10_000, 300, seed))


def test_tree_utils_match_jax():
    jcfg, tcfg = _cfgs(MOE, "bfloat16")
    params = jtr.init_params(jax.random.PRNGKey(4), jcfg)
    model = ttr.from_jax_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    tree = {"embed": model.embed.detach(), "ln_f": model.ln_f.detach(),
            "unembed": model.unembed.detach(),
            "layers": [{k: v.detach() for k, v in lp.items()} for lp in model.layers]}
    assert ttree.tree_count(tree) == jtree.tree_count(params) == tcfg.param_count
    assert ttree.tree_bytes(tree) == jtree.tree_bytes(params)
    assert ttree.tree_bytes(ttr.param_specs(tcfg)) == jtree.tree_bytes(jtr.param_specs(jcfg))
    # f32 sums of ~400,000 squares in another order
    np.testing.assert_allclose(float(ttree.global_norm(tree)), float(jtree.global_norm(params)),
                               rtol=1e-5)
    zeros = ttree.tree_zeros_like(tree)
    assert all(z.dtype == torch.bfloat16 and not z.any() for z in ttree.tree_leaves(zeros))
    assert [tuple(z.shape) for z in ttree.tree_leaves(zeros)] == \
           [tuple(t.shape) for t in ttree.tree_leaves(tree)]
    assert ttree.tree_leaves({"b": [1, None], "a": (2,)}) == [2, 1]


def test_sgd_and_apply_updates_match_jax():
    rng = np.random.default_rng(5)
    ps = {"w": rng.normal(size=(6, 4)).astype(np.float32),
          "b": rng.normal(size=4).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in ps.items()}
             for _ in range(3)]
    sched = jopt.cosine_schedule(0.1, 1, 3)
    jtx = jopt.sgd(sched, momentum=0.9)
    jp, js = jax.tree.map(jnp.asarray, ps), jtx.init(ps)
    tp = [torch.from_numpy(ps[k].copy()) for k in sorted(ps)]
    ttx = topt.SGD(tp, topt.cosine_schedule(0.1, 1, 3), momentum=0.9)
    for g in grads:
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, upd)
        ttx.update([torch.from_numpy(g[k]) for k in sorted(g)])
    assert int(js.step) == ttx.step == 3 and ttx.state()[2] == []
    for k, t in zip(sorted(ps), tp):
        np.testing.assert_allclose(np.asarray(jp[k]), t.numpy(), rtol=1e-6, atol=1e-6)
    for k, m in zip(sorted(ps), ttx.mu):
        np.testing.assert_allclose(np.asarray(js.mu[k]), m.numpy(), rtol=1e-6, atol=1e-6)
    out = topt.apply_updates([torch.ones(2)], [torch.full((2,), 0.5)])
    assert torch.equal(out[0], torch.full((2,), 1.5))
