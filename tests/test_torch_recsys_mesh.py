"""The port's meshed recsys family against the JAX meshed steps.

The JAX side (deepfm, autoint, mind and dlrm-rm2 SMOKE over 1 × 2 and
2 × 2: the serve step's scores, one train step's metrics and updated state)
runs once, in two subprocesses started together (one a mesh), each with
four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``). The port takes the
same JAX ``init_params`` tree through ``from_jax_params`` over its own mesh
of CPU ranks, whose model ranks each hold [F, V/model, dim] of the tables,
and ``make_smoke_inputs``' seeded numpy draws. Tolerances as in
``test_torch_recsys.py``: serve 1e-5, train 5e-5 (AdamW eps 1e-3).
"""
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
from repro.models import recsys as jrs
from repro_torch.configs import get_smoke
from repro_torch.data.smoke import make_smoke_inputs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle
from repro_torch.models import recsys as trs
from repro_torch.models.api import ShapeSpec, TrainState, adamw

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
ARCHS = ("deepfm", "autoint", "mind", "dlrm-rm2")
MESHES = ((1, 2), (2, 2))
SERVE_ATOL = 1e-5
TRAIN_ATOL = 5e-5
LR, EPS = 1e-2, 1e-3

JAX_SIDE = r'''
import sys
import numpy as np, jax
from repro.configs import get_smoke
from repro.data.smoke import make_smoke_inputs
from repro.launch.mesh import make_test_mesh
from repro.models import build_bundle, recsys as jrs
from repro.train import optimizer as jopt

out = {}
ms = eval(sys.argv[2])
mesh = make_test_mesh(*ms)
for arch in %r:
    cfg = get_smoke(arch)[0]
    train, serve = get_smoke(arch)[1]
    params = jrs.init_params(jax.random.PRNGKey(0), cfg)
    bundle = build_bundle(cfg, mesh)
    key = f"{arch}|{ms}"
    with mesh:
        sin = make_smoke_inputs(cfg, serve, mesh, seed=1)["batch"]
        out[key + "|serve"] = np.asarray(jax.jit(bundle.step(serve).fn)(params, sin))
        tx = jopt.adamw(%r, eps=%r)
        fn = jrs.make_train_step(cfg, mesh, tx, ("data",))
        tin = make_smoke_inputs(cfg, train, mesh, seed=2)["batch"]
        (p1, o1), m = jax.jit(fn)((params, tx.init(params)), tin)
    for name, val in m.items():
        out[f"{key}|train_{name}"] = np.asarray(val)
    for i, leaf in enumerate(jax.tree.leaves((p1, o1))):
        out[f"{key}|state{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
''' % (ARCHS, LR, EPS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these models are tiny, and beside other test
    workers a pool of spinning threads makes their steps far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_recsys_mesh")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [(subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(tmp / f"{i}.npz"), repr(ms)],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True), tmp / f"{i}.npz") for i, ms in enumerate(MESHES)]
    out = {}
    try:
        for proc, path in procs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            out.update(np.load(path))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _params(arch):
    return jax.tree.map(np.asarray, jrs.init_params(jax.random.PRNGKey(0),
                                                    jax_get_smoke(arch)[0]))


def _serve_and_train(jax_side, arch, ms, mesh):
    """The serve step's scores and one train step against JAX's run over
    ``ms``; returns the model and the serve step."""
    cfg = get_smoke(arch)[0]
    train, serve = get_smoke(arch)[1]
    key = f"{arch}|{ms}"
    model = trs.from_jax_params(_params(arch), cfg, mesh=mesh)
    bundle = build_bundle(cfg, mesh)
    score = bundle.step(serve).fn(model, make_smoke_inputs(cfg, serve, mesh, seed=1)["batch"])
    np.testing.assert_allclose(score.numpy(), jax_side[key + "|serve"], rtol=0, atol=SERVE_ATOL)
    state = TrainState(model, adamw(model, LR, eps=EPS))
    state, metrics = bundle.step(train).fn(state, make_smoke_inputs(cfg, train, mesh,
                                                                    seed=2)["batch"])
    for name, val in metrics.items():
        np.testing.assert_allclose(float(val), jax_side[f"{key}|train_{name}"], rtol=0,
                                   atol=TRAIN_ATOL, err_msg=name)
    for i, leaf in enumerate(state.leaves()):
        np.testing.assert_allclose(leaf.float().numpy(), jax_side[f"{key}|state{i}"], rtol=0,
                                   atol=TRAIN_ATOL, err_msg=state.leaf_names()[i])
    return model, lambda: bundle.step(serve).fn(model, make_smoke_inputs(cfg, serve, mesh,
                                                                         seed=1)["batch"])


@pytest.mark.parametrize("ms", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_serve_and_train_match_jax(jax_side, arch, ms):
    _serve_and_train(jax_side, arch, ms, make_test_mesh(*ms, device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_steps_over_four_devices_match_jax(jax_side, arch):
    """Over 2 × 2 with each rank on a device of its own (four CPU device
    indices, laid out as four cards), a batch row's ranks read the MLPs and
    table slices stored elsewhere through replicas: serve and train match
    JAX's 2 × 2 run as on one device, and the serve after the update reads
    the new values."""
    mesh = make_test_mesh(2, 2, devices=FOUR)
    model, serve = _serve_and_train(jax_side, arch, (2, 2), mesh)
    serve()
    check_replicas([model], serve)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_model_rank_holds_its_rows_and_lookups_are_exact(arch):
    """Over 2 × 2, model rank j holds rows [j·V/2, (j+1)·V/2) of every
    field (and of DeepFM's wide table) as its own tensor; the whole leaves
    come back exactly; the meshed serve scores equal the unsharded ones bit
    for bit over 1 × 2 (the lookups add zeros to one nonzero partial) and
    within 1e-6 over 2 × 2 (the batch rows split); the out-of-range ids add
    zeros on every rank."""
    cfg = get_smoke(arch)[0]
    serve = get_smoke(arch)[1][1]
    params = _params(arch)
    v = cfg.vocab_per_field
    one = trs.from_jax_params(params, cfg, "cpu")
    batch = make_smoke_inputs(cfg, serve, make_test_mesh(device="cpu"), seed=1)["batch"]
    key = "hist_ids" if arch == "mind" else "sparse_ids"
    batch[key][0].flatten()[:2] = torch.tensor([-3, v + 5], dtype=batch[key].dtype)
    want = build_bundle(cfg, make_test_mesh(device="cpu")).step(serve).fn(one, batch)
    for ms in MESHES:
        mesh = make_test_mesh(*ms, device="cpu")
        model = trs.from_jax_params(params, cfg, mesh=mesh)
        for name in [p for p in ("tables", "wide") if p in model.defs]:
            shards = model.shards(name)
            assert len(shards) == 2
            for j, t in enumerate(shards):
                assert tuple(t.shape) == (cfg.n_sparse, v // 2, params[name].shape[2])
                np.testing.assert_array_equal(t.detach().numpy(),
                                              params[name][:, j * v // 2:(j + 1) * v // 2])
            with pytest.raises(KeyError, match="slices"):
                model[name]
        back = trs.to_jax_params(model)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)
        got = build_bundle(cfg, mesh).step(serve).fn(model, batch)
        if ms[0] == 1:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_meshes_the_reference_refuses_raise():
    cfg = get_smoke("dlrm-rm2")[0]
    with pytest.raises(ValueError, match="vocab_per_field 128 does not split over 3"):
        build_bundle(cfg, make_test_mesh(1, 3, device="cpu"))
    with pytest.raises(ValueError, match="vocab_per_field 128 does not split over 3"):
        trs.init_params(cfg, torch.Generator().manual_seed(0), mesh=make_test_mesh(
            1, 3, device="cpu"))
    bundle = build_bundle(cfg, make_test_mesh(3, 2, device="cpu"))
    with pytest.raises(ValueError, match="batch 64 does not split over 3 batch ranks"):
        bundle.step(get_smoke("dlrm-rm2")[1][0])
    model = trs.init_params(cfg, torch.Generator().manual_seed(0), mesh=make_test_mesh(
        1, 2, device="cpu"))
    serve = build_bundle(cfg, make_test_mesh(1, 4, device="cpu")).step(
        ShapeSpec("s", "rec_serve", {"batch": 8})).fn
    batch = make_smoke_inputs(cfg, get_smoke("dlrm-rm2")[1][1], make_test_mesh(device="cpu"))
    with pytest.raises(ValueError, match="cut over 2 model ranks; the mesh has 4"):
        serve(model, batch["batch"])
