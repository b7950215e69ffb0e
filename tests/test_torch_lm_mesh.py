"""The port's meshed LM against the JAX meshed LM.

The JAX side runs in subprocesses with four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), started together
the first time a test needs them, one a group of cases (``GROUPS``). Both
sides take the JAX ``init_params`` tree (the port through
``from_jax_params`` over its own mesh of CPU ranks) and ``make_smoke_inputs``'
seeded numpy draws.

Cases: the moonshot and qwen3 SMOKE configs in f32 with ``moe_impl`` gather
and a2a over 1 × 2, 1 × 4 and 2 × 2 (prefill logits and cache, one train
step's metrics and parameters; two decode steps' tokens, logits and cache
from the smoke cache, and a decode from the JAX prefill's cache), the
stablelm, moonshot and qwen3 SMOKE decodes of a batch of 1, whose cache the
mesh shards over every axis (and whose MoE batch it replicates), and
mistral SMOKE with ``ffn_impl="sp"`` over 1 × 2. Tolerances are the LM
rules of ``test_torch_transformer.py``: 5e-5 absolute in f32 (the same math
summed in another order), tokens equal; the train step uses AdamW eps 1e-3
as ``test_torch_lm_train.py`` does.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_replicas import FOUR, check_replicas

from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as jtr
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.smoke import make_smoke_inputs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle
from repro_torch.models import transformer as ttr

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
F32_ATOL = 5e-5
LR, WD, EPS = 1e-2, 0.1, 1e-3
PREFILL = ShapeSpec("prefill_sm", "prefill", {"seq_len": 64, "global_batch": 4})
MOE = ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b")
MESHES = ((1, 2), (1, 4), (2, 2))
# (arch, moe_impl, ffn_impl, mesh, kinds); decode does not shard the MoE's
# sequence, so a2a and gather decode alike: it runs once a mesh and arch
GROUPS = {
    f"{d}x{m}": [(arch, impl, "gatherw", (d, m),
                  ("prefill", "train") + (("decode",) if impl == "gather" else ()))
                 for arch in MOE for impl in ("gather", "a2a")]
    for d, m in MESHES}
# a batch of 1 over 2 × 2: the cache's sequence over every rank, the MoE's
# batch replicated over "data"
GROUPS["other"] = [("stablelm-3b", "gather", "gatherw", (2, 2), ("decode1",)),
                   ("stablelm-3b", "gather", "gatherw", (1, 4), ("decode1",)),
                   *[(arch, "gather", "gatherw", (2, 2), ("decode1",)) for arch in MOE],
                   ("mistral-large-123b", "gather", "sp", (1, 2), ("prefill", "train", "decode"))]

JAX_SIDE = r'''
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke
from repro.configs.base import ShapeSpec
from repro.data.smoke import make_smoke_inputs
from repro.launch.mesh import make_test_mesh
from repro.models import layers as L
from repro.models import transformer as jtr
from repro.train import optimizer as jopt

PREFILL = ShapeSpec("prefill_sm", "prefill", {"seq_len": 64, "global_batch": 4})
cases, path = eval(sys.argv[1]), sys.argv[2]
out = {}


def decode_logits(cfg, mesh, b):
    """The reference's decode step, returning its logits too."""
    batch_axes, seq_axes = jtr._decode_seq_axes(mesh, b)
    bspec = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)
    P = jax.sharding.PartitionSpec

    def step(params, cache, tokens, pos):
        x = params["embed"][tokens].astype(jnp.float32)
        x = jtr._constrain(x, mesh, P(bspec, None, None))

        def layer(carry, xs):
            x, kc, vc = carry
            lp, li = xs
            h = L.rmsnorm(x, lp["ln1"])
            q = jnp.einsum("bsd,dq->bsq", h, lp["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
            k = jnp.einsum("bsd,dq->bsq", h, lp["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
            v = jnp.einsum("bsd,dq->bsq", h, lp["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
            posv = jnp.full((b, 1), pos, jnp.int32)
            q = L.apply_rope(q, posv, cfg.rope_theta)
            k = L.apply_rope(k, posv, cfg.rope_theta)
            kc = jtr._cache_insert(kc, k, li, pos, mesh, bspec, seq_axes)
            vc = jtr._cache_insert(vc, v, li, pos, mesh, bspec, seq_axes)
            o = jtr._flash_decode(q, kc, vc, li, pos + 1, mesh, bspec, seq_axes, cfg.n_heads)
            o = jnp.einsum("bsq,qd->bsd", o.astype(jnp.float32).reshape(b, 1, -1), lp["wo"])
            x = x + o
            h2 = L.rmsnorm(x, lp["ln2"])
            if cfg.moe is None:
                ff = L.swiglu_mlp(h2, lp["wi"], lp["wg"], lp["wo_ff"])
            else:
                ff, _ = jtr._moe_block(h2, lp, cfg, mesh, batch_axes, seq_sharded=False)
            return (x + ff, kc, vc), None

        (x, kn, vn), _ = jax.lax.scan(layer, (x, cache["k"], cache["v"]),
                                      (params["layers"], jnp.arange(cfg.n_layers)))
        x = L.rmsnorm(x[:, 0], params["ln_f"])
        logits = jnp.einsum("bd,dv->bv", x, params["unembed"]).astype(jnp.float32)
        return jnp.argmax(logits, -1).astype(jnp.int32), logits, {"k": kn, "v": vn}

    return jax.jit(step)


for arch, impl, ffn, ms, kinds in cases:
    cfg = dataclasses.replace(get_smoke(arch)[0], dtype="float32", moe_impl=impl, ffn_impl=ffn)
    mesh = make_test_mesh(*ms)
    key = f"{arch}|{impl}|{ffn}|{ms}"
    params = jtr.init_params(jax.random.PRNGKey(0), cfg)
    if "prefill" in kinds:
        tin = make_smoke_inputs(cfg, PREFILL, mesh, seed=1)
        with mesh:
            lg, pc = jax.jit(jtr.make_prefill_step(cfg, mesh))(params, tin["tokens"])
        out[key + "|prefill_logits"] = np.asarray(lg)
        out[key + "|prefill_k"] = np.asarray(pc["k"])
        out[key + "|prefill_v"] = np.asarray(pc["v"])
    if "decode" in kinds or "decode1" in kinds:
        gb = 1 if "decode1" in kinds else 4
        shape = ShapeSpec("d", "decode", {"seq_len": 64, "global_batch": gb})
        din = make_smoke_inputs(cfg, shape, mesh, seed=1)
        fn = decode_logits(cfg, mesh, gb)
        cache, tok = din["cache"], din["tokens"]
        with mesh:
            for i in range(2):
                nxt, lg, cache = fn(params, cache, tok, jnp.int32(32 + i))
                out[f"{key}|decode{i}_tok"] = np.asarray(nxt)
                out[f"{key}|decode{i}_logits"] = np.asarray(lg)
                tok = nxt[:, None]
            out[key + "|decode_k"] = np.asarray(cache["k"])
            if "prefill" in kinds:
                nxt, lg, _ = fn(params, pc, din["tokens"], jnp.int32(40))
                out[key + "|fromprefill_logits"] = np.asarray(lg)
    if "train" in kinds:
        tin = make_smoke_inputs(cfg, get_smoke(arch)[1][0], mesh, seed=2)
        tx = jopt.adamw(%r, weight_decay=%r, eps=%r)
        with mesh:
            (p2, _), m = jax.jit(jtr.make_train_step(cfg, mesh, tx))((params, tx.init(params)),
                                                                     tin["batch"])
        for name, val in m.items():
            out[f"{key}|train_{name}"] = np.asarray(val)
        for i, leaf in enumerate(jax.tree.leaves(p2)):
            out[f"{key}|param{i}"] = np.asarray(leaf)
np.savez(path, **out)
''' % (LR, WD, EPS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these models are tiny, and beside the JAX
    subprocesses and other test workers a pool of spinning threads makes
    their steps far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Starts one JAX subprocess a group, all at once; ``jax_side(group)``
    waits for that group's and returns its arrays."""
    tmp = tmp_path_factory.mktemp("jax_lm_mesh")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {g: (subprocess.Popen([sys.executable, "-c", JAX_SIDE, repr(cases), str(tmp / g)],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True), tmp / f"{g}.npz")
             for g, cases in GROUPS.items()}
    done = {}

    def get(group):
        if group not in done:
            proc, path = procs[group]
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            done[group] = dict(np.load(path))
        return done[group]

    yield get
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _cfg(arch, impl, ffn):
    return dataclasses.replace(get_smoke(arch)[0], dtype="float32", moe_impl=impl, ffn_impl=ffn)


def _params(arch, impl, ffn):
    jcfg = dataclasses.replace(jax_get_smoke(arch)[0], dtype="float32", moe_impl=impl,
                               ffn_impl=ffn)
    return jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0), jcfg))


def _close(want, got, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    err = float(np.abs(want - got).max()) if want.size else 0.0
    assert err <= F32_ATOL, (what, err)


def _case_id(case):
    arch, impl, ffn, ms, kinds = case
    batch1 = "-batch1" if arch in MOE and "decode1" in kinds else ""
    return f"{arch}-{impl}-{ffn}-{ms[0]}x{ms[1]}{batch1}"


CASES = [(g, c) for g, cases in GROUPS.items() for c in cases]


def _check_case(want, case, devices=("cpu",)):
    """Prefill logits and cache, decode tokens, logits and cache (and a
    decode from the JAX prefill's cache), one train step's metrics and
    updated parameters, each over the same mesh as the JAX run, its ranks
    round-robin over ``devices``; returns the model and a prefill."""
    arch, impl, ffn, ms, kinds = case
    key = f"{arch}|{impl}|{ffn}|{ms}"
    cfg = _cfg(arch, impl, ffn)
    mesh = make_test_mesh(*ms, devices=list(devices))
    params = _params(arch, impl, ffn)
    model = ttr.from_jax_params(params, cfg, mesh=mesh)
    bundle = build_bundle(cfg, mesh)
    if "prefill" in kinds:
        tin = make_smoke_inputs(cfg, PREFILL, mesh, seed=1)
        logits, cache = bundle.step(PREFILL).fn(model, tin["tokens"])
        _close(want[key + "|prefill_logits"], logits, "prefill logits")
        whole = ttr.join_cache(cache, mesh, 4)
        _close(want[key + "|prefill_k"], whole["k"], "prefill k")
        _close(want[key + "|prefill_v"], whole["v"], "prefill v")
    if "decode" in kinds or "decode1" in kinds:
        gb = 1 if "decode1" in kinds else 4
        shape = ShapeSpec("d", "decode", {"seq_len": 64, "global_batch": gb})
        din = make_smoke_inputs(cfg, shape, mesh, seed=1)
        step = bundle.step(shape).fn
        cache, tok = din["cache"], din["tokens"]
        for i in range(2):
            logits = ttr.decode_logits(model, {n: [t.clone() for t in c] for n, c in cache.items()},
                                       tok, 32 + i, mesh)
            nxt, cache = step(model, cache, tok, 32 + i)
            np.testing.assert_array_equal(want[f"{key}|decode{i}_tok"], nxt.numpy())
            _close(want[f"{key}|decode{i}_logits"], logits, f"decode {i} logits")
            tok = nxt[:, None]
        _close(want[key + "|decode_k"], ttr.join_cache(cache, mesh, gb)["k"], "decode cache")
        if "prefill" in kinds:
            jc = {n: torch.from_numpy(want[f"{key}|prefill_{n}"]) for n in ("k", "v")}
            logits = ttr.decode_logits(model, ttr.split_cache(jc, mesh), din["tokens"], 40, mesh)
            _close(want[key + "|fromprefill_logits"], logits, "decode from the JAX prefill")
    if "train" in kinds:
        tin = make_smoke_inputs(cfg, get_smoke(arch)[1][0], mesh, seed=2)
        state = ttr.TrainState(model, ttr.adamw(model, LR, weight_decay=WD, eps=EPS))
        state, metrics = bundle.step(get_smoke(arch)[1][0]).fn(state, tin["batch"])
        for name, val in metrics.items():
            _close(want[f"{key}|train_{name}"], val, f"train {name}")
        for i, leaf in enumerate(jax.tree.leaves(ttr.to_jax_params(model))):
            _close(want[f"{key}|param{i}"], leaf, f"param {i}")
    tokens = make_smoke_inputs(cfg, PREFILL, mesh, seed=1)["tokens"]
    return model, lambda: bundle.step(PREFILL).fn(model, tokens)


@pytest.mark.parametrize("group,case", CASES, ids=[_case_id(c) for _, c in CASES])
def test_meshed_lm_matches_jax(jax_side, group, case):
    _check_case(jax_side(group), case)


@pytest.mark.parametrize("impl", ("gather", "a2a"))
def test_meshed_moe_over_four_devices_matches_jax(jax_side, impl):
    """moonshot over 2 × 2 with each rank on a device of its own
    (``_torch_replicas``): batch row 1's ranks read the router and the
    experts through replicas; prefill, decode and the train step match
    JAX's 2 × 2 run as on one device, and a prefill after the update reads
    the new weights."""
    case = next(c for c in GROUPS["2x2"] if c[0] == MOE[0] and c[1] == impl)
    model, prefill = _check_case(jax_side("2x2"), case, FOUR)
    prefill()
    check_replicas(list(model.layers), prefill)


def test_moonshot_decodes_differ_where_jax_does(jax_side):
    """MoE capacity follows the per-rank batch: the 1 × 2 and 2 × 2 decodes
    of one smoke cache differ in tokens exactly where JAX's do."""
    arch = "moonshot-v1-16b-a3b"
    tokens = {}
    for ms in ((1, 2), (2, 2)):
        key = f"{arch}|gather|gatherw|{ms}"
        want = jax_side(f"{ms[0]}x{ms[1]}")
        cfg = _cfg(arch, "gather", "gatherw")
        mesh = make_test_mesh(*ms, device="cpu")
        model = ttr.from_jax_params(_params(arch, "gather", "gatherw"), cfg, mesh=mesh)
        shape = get_smoke(arch)[1][1]
        din = make_smoke_inputs(cfg, shape, mesh, seed=1)
        nxt, _ = build_bundle(cfg, mesh).step(shape).fn(model, din["cache"], din["tokens"], 32)
        tokens[ms] = (want[key + "|decode0_tok"], nxt.numpy())
    (j12, t12), (j22, t22) = tokens[(1, 2)], tokens[(2, 2)]
    np.testing.assert_array_equal(j12 != j22, t12 != t22)


def test_each_rank_holds_its_experts_and_cache_slice():
    """Model rank j holds experts [j·E/model, (j+1)·E/model) of every layer,
    as its own tensor; the decode cache is one [L, B_loc, S_loc, KV, Dh]
    tensor a rank; the whole leaves and the whole cache come back exactly."""
    arch = "moonshot-v1-16b-a3b"
    cfg = _cfg(arch, "gather", "gatherw")
    params = _params(arch, "gather", "gatherw")
    for ms in ((1, 4), (2, 2)):
        mesh = make_test_mesh(*ms, device="cpu")
        model = ttr.from_jax_params(params, cfg, mesh=mesh)
        n = ms[1]
        e_loc = cfg.moe.n_experts // n
        for j in range(n):
            got = model.layers[1][f"wi_e:{j}"]
            assert tuple(got.shape) == (e_loc, cfg.d_model, cfg.moe.d_ff_expert)
            np.testing.assert_array_equal(got.detach().numpy(),
                                          params["layers"]["wi_e"][1, j * e_loc:(j + 1) * e_loc])
        assert "wi_e" not in model.layers[0]
        back = ttr.to_jax_params(model)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)
        shape = get_smoke(arch)[1][1]
        din = make_smoke_inputs(cfg, shape, mesh, seed=1)
        assert len(din["cache"]["k"]) == 4
        assert {tuple(t.shape) for t in din["cache"]["k"]} == {
            (cfg.n_layers, 4 // ms[0], 64 // ms[1], cfg.n_kv_heads, cfg.head_dim)}
        one_rank = make_test_mesh(device="cpu")
        whole = ttr.join_cache(make_smoke_inputs(cfg, shape, one_rank, seed=1)["cache"],
                               one_rank, 4)
        joined = ttr.join_cache(din["cache"], mesh, 4)
        assert all(torch.equal(joined[n], whole[n]) for n in ("k", "v"))
        # a batch of one cuts the sequence over every rank
        one = ttr.split_cache({n: t[:, :1] for n, t in whole.items()}, mesh)
        assert [tuple(t.shape[1:3]) for t in one["k"]] == [(1, 16)] * 4


def test_meshes_the_reference_refuses_raise():
    """E, F, the batch, the sequence or the cache that the mesh does not
    split raise, naming the quantity."""
    moon = _cfg("moonshot-v1-16b-a3b", "gather", "gatherw")
    with pytest.raises(ValueError, match="n_experts 8 does not split over 3"):
        build_bundle(moon, make_test_mesh(1, 3, device="cpu"))
    sp = _cfg("mistral-large-123b", "gather", "sp")
    with pytest.raises(ValueError, match="does not split over 5 model ranks"):
        build_bundle(sp, make_test_mesh(1, 5, device="cpu"))
    bundle = build_bundle(moon, make_test_mesh(4, 2, device="cpu"))
    with pytest.raises(ValueError, match="batch 2 does not split over 4 batch ranks"):
        bundle.step(ShapeSpec("t", "train", {"seq_len": 64, "global_batch": 2}))
    with pytest.raises(ValueError, match="sequence 63 does not split over 2 model ranks"):
        bundle.step(ShapeSpec("p", "prefill", {"seq_len": 63, "global_batch": 4}))
    with pytest.raises(ValueError, match="cache length 63 does not split over 2 sequence"):
        bundle.step(ShapeSpec("d", "decode", {"seq_len": 63, "global_batch": 4}))
    with pytest.raises(ValueError, match="moe_impl"):
        dataclasses.replace(moon, moe_impl="ring")
    with pytest.raises(ValueError, match="ffn_impl"):
        dataclasses.replace(moon, ffn_impl="tp")
    model = ttr.init_params(moon, torch.Generator().manual_seed(0), "cpu",
                            mesh=make_test_mesh(1, 2, device="cpu"))
    with pytest.raises(ValueError, match="cut over 2 model ranks"):
        ttr.forward(model, torch.zeros((4, 8), dtype=torch.int32),
                    mesh=make_test_mesh(1, 4, device="cpu"))
