"""The port's LM serving path (``repro_torch.models.transformer``, the arch
registry, ``build_bundle`` and the smoke inputs) against the JAX package on
the same inputs: the JAX ``init_params`` tree carried through
``from_jax_params``, and ``make_smoke_inputs``' seeded numpy draws.

Tolerances:
  * f32: logits, hidden states and caches agree to 5e-5 absolute (the same
    math summed in another order); decoded tokens are equal.
  * bf16: every op rounds to bf16 on both sides, and JAX's CPU rounds some
    elementwise ops (silu, exp) differently from torch's, so values drift by
    a few bf16 steps through the layers. Logits agree to 4 bf16 steps (2^-7
    relative each) of the largest |logit|, and their argmax where the top-2
    margin is wider than that. A cache row (one layer, sequence, position)
    agrees to 4 bf16 steps of the largest |value| of the cache; in the dense
    configs every row does, in the MoE configs at most 1% may not: a token
    whose router probabilities nearly tie can take another expert once its
    input moved by a bf16 step. A decoded token is equal wherever the port's
    top-2 logit margin is wider than twice the logit tolerance (with random
    weights some margins are a hundredth of a logit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.data.smoke import make_smoke_inputs as jax_smoke_inputs
from repro.models import build_bundle as jax_build_bundle
from repro.models import transformer as jtr
from repro.utils.compat import make_mesh
from repro_torch.configs import ARCH_IDS, all_cells, canon, get_config, get_smoke
from repro_torch.data.smoke import make_smoke_inputs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle
from repro_torch.models import transformer as ttr
from repro_torch.models.api import ShapeSpec

LM_ARCHS = ARCH_IDS[:5]
DTYPES = ("float32", "bfloat16")
F32_ATOL = 5e-5
BF16_STEPS = 4
MOE_ROW_SHARE = 0.01
PREFILL = ShapeSpec("prefill_sm", "prefill", {"seq_len": 64, "global_batch": 4})

JMESH = make_mesh((1, 1), ("data", "model"))
TMESH = make_test_mesh(device="cpu")
_MEMO: dict = {}


def _jax_shape(shape: ShapeSpec) -> JaxShapeSpec:
    return JaxShapeSpec(shape.name, shape.kind, dict(shape.dims))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x


def _case(arch: str, dtype: str) -> dict:
    """The JAX and port bundles of ``arch``'s SMOKE config in ``dtype``, one
    JAX parameter tree carried into the port, and the jitted JAX steps."""
    key = (arch, dtype)
    if key not in _MEMO:
        jcfg = dataclasses.replace(jax_get_smoke(arch)[0], dtype=dtype)
        tcfg = dataclasses.replace(get_smoke(arch)[0], dtype=dtype)
        params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
        jb = jax_build_bundle(jcfg, JMESH)
        decode_shape = get_smoke(arch)[1][1]
        _MEMO[key] = dict(
            jcfg=jcfg, tcfg=tcfg, params=params, jb=jb, tb=build_bundle(tcfg, TMESH),
            model=ttr.from_jax_params(jax.tree.map(np.asarray, params), tcfg, "cpu"),
            decode_shape=decode_shape,
            jprefill=jax.jit(jb.step(_jax_shape(PREFILL)).fn),
            jdecode=jax.jit(jb.step(_jax_shape(decode_shape)).fn))
    return _MEMO[key]


def _bf16_atol(ref: np.ndarray) -> float:
    return BF16_STEPS * float(np.abs(ref).max()) * 2.0 ** -7


def _check_logits(j, t, dtype):
    a, b = _np(j), _np(t)
    atol = F32_ATOL if dtype == "float32" else _bf16_atol(a)
    assert np.abs(a - b).max() <= atol, (np.abs(a - b).max(), atol)
    top2 = np.sort(a, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * atol
    assert (a.argmax(-1) == b.argmax(-1))[clear].all()


def _check_tokens(jtok, ttok, logits, dtype):
    """``ttok`` is ``logits``' argmax; JAX's tokens equal it (in bf16 where
    the margin is clear)."""
    j, t, lg = np.asarray(jtok), ttok.numpy(), _np(logits)
    np.testing.assert_array_equal(t, lg.argmax(-1))
    if dtype == "float32":
        np.testing.assert_array_equal(j, t)
        return
    top2 = np.sort(lg, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * _bf16_atol(lg)
    assert (j == t)[clear].all(), (j, t, top2)


def _port_decode(c, shape, cache, tokens, pos):
    """The bundle's decode step on ``cache`` (the one rank's slice, in
    place), and the logits of the same step on a copy of the cache as it
    was."""
    logits = ttr.decode_logits(c["model"], {n: [t.clone() for t in s] for n, s in cache.items()},
                               tokens, pos)
    nxt, cache = c["tb"].step(shape).fn(c["model"], cache, tokens, pos)
    return nxt, cache, logits


def _check_cache(j, t, dtype, moe: bool):
    """j, t: [L, B, S, KV, Dh]; a row is one (layer, sequence, position)."""
    a, b = _np(j), _np(t)
    assert a.shape == b.shape
    if dtype == "float32":
        assert np.abs(a - b).max() <= F32_ATOL, np.abs(a - b).max()
        return
    row_err = np.abs(a - b).reshape(*a.shape[:3], -1).max(-1)
    off = int((row_err > _bf16_atol(a)).sum())
    assert off <= (MOE_ROW_SHARE * row_err.size if moe else 0), (off, row_err.max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_matches_jax(arch, dtype):
    c = _case(arch, dtype)
    jin = jax_smoke_inputs(c["jcfg"], _jax_shape(PREFILL), JMESH, seed=1)
    tin = make_smoke_inputs(c["tcfg"], PREFILL, TMESH, seed=1)
    np.testing.assert_array_equal(np.asarray(jin["tokens"]), tin["tokens"].numpy())
    with JMESH:
        jl, jc = c["jprefill"](c["params"], jin["tokens"])
    tl, tc = c["tb"].step(PREFILL).fn(c["model"], tin["tokens"])
    assert len(tc["k"]) == len(tc["v"]) == 1                 # one rank: one slice, whole
    tc = ttr.join_cache(tc, TMESH, 4)
    assert tl.dtype == torch.float32 and tl.shape == (4, c["tcfg"].vocab)
    _check_logits(jl, tl, dtype)
    for name in ("k", "v"):
        assert tc[name].dtype == getattr(torch, dtype)
        _check_cache(jc[name], tc[name], dtype, c["tcfg"].moe is not None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_jax(arch, dtype):
    """One decode step from ``make_smoke_inputs``' random cache at pos 32:
    the same next tokens, the same cache written in place at pos."""
    c = _case(arch, dtype)
    shape = c["decode_shape"]
    jin = jax_smoke_inputs(c["jcfg"], _jax_shape(shape), JMESH, seed=1)
    tin = make_smoke_inputs(c["tcfg"], shape, TMESH, seed=1)
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(jin["cache"][name]), _np(tin["cache"][name][0]))
    np.testing.assert_array_equal(np.asarray(jin["tokens"]), tin["tokens"].numpy())
    assert int(jin["pos"]) == int(tin["pos"]) == shape["seq_len"] // 2
    with JMESH:
        jt, jc = c["jdecode"](c["params"], jin["cache"], jin["tokens"], jin["pos"])
    before = tin["cache"]["k"][0].clone()
    tt, tc, logits = _port_decode(c, shape, tin["cache"], tin["tokens"], tin["pos"])
    assert tc["k"][0] is tin["cache"]["k"][0]                 # written in place
    pos = int(tin["pos"])
    changed = (tc["k"][0] != before).any(-1).any(-1)          # [L, B, S]
    assert not changed[:, :, torch.arange(64) != pos].any()
    _check_tokens(jt, tt, logits, dtype)
    for name in ("k", "v"):
        _check_cache(jc[name], tc[name][0], dtype, c["tcfg"].moe is not None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_continues_a_jax_prefill(arch, dtype):
    """The JAX prefill's cache of 48 positions, padded to the decode
    shape's 64, fed to the port's decode and to the JAX decode: two greedy
    steps give the same tokens (each step fed JAX's previous tokens)."""
    c = _case(arch, dtype)
    toks = np.random.default_rng(2).integers(1, c["tcfg"].vocab, (4, 48)).astype(np.int32)
    with JMESH:
        jl, jc = jax.jit(c["jb"].step(JaxShapeSpec("p48", "prefill", {
            "seq_len": 48, "global_batch": 4})).fn)(c["params"], jnp.asarray(toks))
    pad = ((0, 0), (0, 0), (0, 16), (0, 0), (0, 0))
    jcache = {n: jnp.pad(jc[n], pad) for n in ("k", "v")}
    tcache = ttr.split_cache({n: torch.from_numpy(_np(jcache[n])).to(getattr(torch, dtype))
                              for n in ("k", "v")}, TMESH)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for pos in (48, 49):
        with JMESH:
            jnext, jcache = c["jdecode"](c["params"], jcache, jnp.asarray(tok), jnp.int32(pos))
        tnext, tcache, logits = _port_decode(c, c["decode_shape"], tcache, torch.from_numpy(tok),
                                             pos)
        _check_tokens(jnext, tnext, logits, dtype)
        tok = np.array(jnext)[:, None]
    for name in ("k", "v"):
        _check_cache(jcache[name], tcache[name][0], dtype, c["tcfg"].moe is not None)


@pytest.mark.parametrize("q_offset", [0, 16])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_jax(arch, q_offset):
    c = _case(arch, "float32")
    toks = np.random.default_rng(3).integers(1, c["tcfg"].vocab, (2, 32)).astype(np.int32)
    with JMESH:
        jh, jaux = jax.jit(lambda p, t: jtr.forward(p, t, c["jcfg"], JMESH, q_offset=q_offset))(
            c["params"], jnp.asarray(toks))
    th, taux = ttr.forward(c["model"], torch.from_numpy(toks), q_offset=q_offset)
    assert th.requires_grad                     # the training forward: autograd records
    np.testing.assert_allclose(_np(jh), _np(th), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(float(jaux), float(taux.detach()), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_params_round_trip_and_count(arch, dtype):
    """to_jax_params(from_jax_params(p)) == p: f32 leaves bit for bit,
    bfloat16 leaves as f32 arrays of the same values (npy has no bf16). The
    config's param_count is the port's numel and the JAX tree's size."""
    c = _case(arch, dtype)
    back = ttr.to_jax_params(c["model"])
    flat_j, tree_j = jax.tree.flatten(c["params"])
    flat_t, tree_t = jax.tree.flatten(back)
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        a = np.asarray(a)
        assert b.dtype == np.float32 and a.shape == b.shape
        if dtype == "float32":
            assert a.dtype == np.float32 and np.array_equal(a.view(np.uint32), b.view(np.uint32))
        else:
            np.testing.assert_array_equal(a.astype(np.float32), b)
    n = c["tcfg"].param_count
    assert n == c["jcfg"].param_count == sum(int(np.size(a)) for a in flat_j)
    assert n == sum(p.numel() for p in c["model"].parameters())
    assert c["tcfg"].active_param_count == c["jcfg"].active_param_count


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_specs_and_init(arch):
    """param_specs and cache_specs have the reference's shapes; a bundle's
    init draws norms of ones and weights of std 1/sqrt(fan_in)."""
    cfg, jcfg = get_config(arch)[0], jax_get_config(arch)[0]
    jspecs = jax.tree.map(lambda s: tuple(s.shape), jtr.param_specs(jcfg))
    tspecs = jax.tree.map(lambda s: tuple(s.shape), ttr.param_specs(cfg))
    assert jspecs == tspecs
    assert all(s.device.type == "meta" for s in jax.tree.leaves(ttr.param_specs(cfg)))
    jc, tc = jtr.cache_specs(jcfg, 8, 2048), ttr.cache_specs(cfg, 8, 2048)
    assert {n: tuple(s.shape) for n, s in jc.items()} == {n: tuple(s.shape) for n, s in tc.items()}
    smoke = get_smoke(arch)[0]
    model = build_bundle(smoke, TMESH).init(torch.Generator().manual_seed(0))
    assert model.device.type == "cpu" and all(
        bool((lp["ln1"] == 1).all()) for lp in model.layers)
    wq = model.layers[0]["wq"].detach().float()
    assert abs(float(wq.std()) * np.sqrt(smoke.d_model) - 1.0) < 0.1


def test_registry_matches_jax():
    """The reference's twelve ids in its order, each config, shape list and
    smoke config equal to the reference's."""
    assert ARCH_IDS == JAX_ARCH_IDS
    assert len(ARCH_IDS) == 12 and canon("dlrm-rm2") in ARCH_IDS

    def fields(cfg):
        d = dataclasses.asdict(cfg)
        return {k: d[k] for k in d if not k.startswith("_")}

    for arch in ARCH_IDS:
        for port, ref in ((get_config(arch), jax_get_config(arch)),
                          (get_smoke(arch), jax_get_smoke(arch))):
            (tcfg, tshapes), (jcfg, jshapes) = port, ref
            jf = fields(jcfg)
            tf = fields(tcfg)
            assert {k: jf[k] for k in tf} == tf, arch
            assert [(s.name, s.kind, dict(s.dims)) for s in tshapes] == \
                   [(s.name, s.kind, dict(s.dims)) for s in jshapes], arch
    assert len(list(all_cells())) == 5 * 4 + 4 + 4 * 4 + 2 * 2


def test_lm_bundle_scope():
    """Every LM kind of the reference builds a step (train: the train step
    over [gb, s] int32 tokens and labels, the bundle's optimizer the
    reference's AdamW); a mesh whose 3 model ranks do not split the
    sequence raises."""
    cfg, shapes = get_smoke("stablelm-3b")
    bundle = build_bundle(cfg, TMESH)
    train = bundle.step(shapes[0])
    assert {n: (tuple(t.shape), t.dtype) for n, t in train.input_specs.items()} == {
        n: ((4, 64), torch.int32) for n in ("tokens", "labels")}
    model = bundle.init(torch.Generator().manual_seed(0))
    tx = bundle.optimizer(model)
    assert tx.weight_decay == 0.1 and tx.lr_fn(100) == pytest.approx(3e-4)
    assert len(tx.params) == sum(1 for _ in model.parameters())
    state, metrics = train.fn(ttr.TrainState(model, tx), make_smoke_inputs(
        cfg, shapes[0], TMESH, seed=0)["batch"])
    assert tx.step == 1 and set(metrics) == {"loss", "ce", "moe_aux", "grad_norm"}
    with pytest.raises(ValueError, match="shape kind"):
        bundle.step(ShapeSpec("x", "lira_serve", {"seq_len": 1, "global_batch": 1}))
    with pytest.raises(ValueError, match="sequence 64 does not split over 3 model ranks"):
        build_bundle(cfg, make_test_mesh(1, 3, device="cpu")).step(shapes[0])
    with pytest.raises(TypeError):
        build_bundle(object(), TMESH)


def test_lm_smoke_train_inputs_match_jax():
    cfg, shapes = get_smoke("moonshot-v1-16b-a3b")
    j = jax_smoke_inputs(jax_get_smoke("moonshot-v1-16b-a3b")[0], _jax_shape(shapes[0]), JMESH,
                         seed=4)
    t = make_smoke_inputs(cfg, shapes[0], TMESH, seed=4)
    for name in ("tokens", "labels"):
        np.testing.assert_array_equal(np.asarray(j["batch"][name]), t["batch"][name].numpy())


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    """The model, the train step's mesh, the training launcher and the
    pre-training example run on the card unless asked for the CPU."""
    from repro_torch.examples import lm_pretrain
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("stablelm-3b")[0]
    tree = ttr.to_jax_params(_case("stablelm_3b", "float32")["model"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.from_jax_params(tree, cfg)
    assert ttr.from_jax_params(tree, cfg, "cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.make_train_step(cfg, make_test_mesh())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_pretrain.main(steps=1)


@pytest.mark.parametrize("arch", ["lira_ann", "lira_ann_q"])
def test_lira_bundles_match_jax(arch):
    """lira_serve and lira_train at SMOKE_SHAPES: equal smoke inputs, the
    serve step's answers equal to the JAX step's from the same probing
    parameters, one train step's loss, gradient norm and parameters equal."""
    from repro.train import optimizer as jopt
    from repro_torch.core import probing as tprobing

    jcfg, jshapes = jax_get_smoke(arch)
    tcfg, tshapes = get_smoke(arch)
    jb, tb = jax_build_bundle(jcfg, JMESH), build_bundle(tcfg, TMESH)
    params = jb.init(jax.random.PRNGKey(0))
    model = tprobing.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    specs = tb.param_specs()
    assert all(t.device.type == "meta" for t in specs.values())
    assert sum(t.numel() for t in specs.values()) == sum(np.size(a) for a in jax.tree.leaves(params))
    drawn = tb.init(torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in drawn.parameters()] == [tuple(t.shape) for t in specs.values()]
    serve, train = tshapes
    jin = jax_smoke_inputs(jcfg, _jax_shape(serve), JMESH, seed=1)
    tin = make_smoke_inputs(tcfg, serve, TMESH, seed=1)
    assert set(jin["store"]) == set(tin["store"])
    for name in jin["store"]:
        np.testing.assert_array_equal(_np(jin["store"][name]), _np(tin["store"][name]))
    np.testing.assert_array_equal(_np(jin["queries"]), _np(tin["queries"]))
    specs = tb.step(serve).input_specs
    assert {n: tuple(s.shape) for n, s in specs["store"].items()} == \
           {n: tuple(t.shape) for n, t in tin["store"].items()}
    with JMESH:
        jd, ji, jn, jo = jax.jit(jb.step(_jax_shape(serve)).fn)(params, jin["store"], jin["queries"])
    td, ti, tn, to, _ = tb.step(serve).fn(model, tin["store"], tin["queries"])
    np.testing.assert_allclose(_np(jd), _np(td), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(ji), _np(ti))
    np.testing.assert_array_equal(_np(jn), _np(tn))
    assert int(np.asarray(jo).sum()) == int(to)

    jin = jax_smoke_inputs(jcfg, _jax_shape(train), JMESH, seed=1)
    tin = make_smoke_inputs(tcfg, train, TMESH, seed=1)
    for name in jin["batch"]:
        np.testing.assert_array_equal(_np(jin["batch"][name]), _np(tin["batch"][name]))
    with JMESH:
        (jp, _), jm = jax.jit(jb.step(_jax_shape(train)).fn)(
            (params, jopt.adamw(1e-3).init(params)), jin["batch"])
    state = (model, tb.optimizer(model))
    state_out, tm = tb.step(train).fn(state, tin["batch"])
    assert state_out[0] is model
    np.testing.assert_allclose(float(jm["loss"]), float(tm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(jm["grad_norm"]), float(tm["grad_norm"]), rtol=1e-5)
    back = tprobing.params_to_jax(model)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-6)
