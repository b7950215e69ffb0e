"""The port's edge-sharded DimeNet against the JAX meshed DimeNet.

The JAX side (DimeNet SMOKE at molecule_sm and graph_sm over 2 × 2: the
forward's predictions and one train step's metrics and updated state) runs
once, in a subprocess with four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), on the smoke batch
laid out for four shards. The port takes the same JAX ``init_params`` tree
and the same batch (``make_smoke_inputs`` over its own 2 × 2 mesh of CPU
ranks). The meshed model is the reference's meshed function, which on more
than one rank is not the one-rank model (``models.dimenet``'s docstring):
the tests hold it against JAX's meshed run. Tolerances as in
``test_torch_dimenet.py``: forward 1e-5, train 5e-5 (AdamW eps 1e-3).
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
from repro.models import dimenet as jdn
from repro_torch.configs import get_smoke
from repro_torch.data.smoke import make_smoke_inputs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle
from repro_torch.models import dimenet as tdn
from repro_torch.models.api import TrainState, adamw

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
SHAPES = {s.name: s for s in get_smoke("dimenet")[1]}
FWD_ATOL = 1e-5
TRAIN_ATOL = 5e-5
LR, EPS = 1e-2, 1e-3
MESH = (2, 2)

JAX_SIDE = r'''
import sys
import numpy as np, jax
from repro.configs import get_smoke
from repro.data.smoke import make_smoke_inputs
from repro.launch.mesh import make_test_mesh
from repro.models import dimenet as jdn
from repro.train import optimizer as jopt

cfg = get_smoke("dimenet")[0]
mesh = make_test_mesh(*%r)
out = {}
for shape in get_smoke("dimenet")[1]:
    n_nodes, d_feat = shape["n_nodes"] * shape.dims.get("batch", 1), shape["d_feat"]
    params = jdn.init_params(jax.random.PRNGKey(0), cfg, d_feat)
    batch = make_smoke_inputs(cfg, shape, mesh, seed=0)["batch"]
    tx = jopt.adamw(%r, eps=%r)
    with mesh:
        out[shape.name + "|pred"] = np.asarray(jax.jit(lambda p, b: jdn.forward(
            p, b, cfg, mesh, n_nodes=n_nodes, d_feat=d_feat))(params, batch))
        (p1, o1), m = jax.jit(jdn.make_train_step(cfg, mesh, tx, n_nodes=n_nodes,
                                                  d_feat=d_feat))((params, tx.init(params)), batch)
    for name, val in m.items():
        out[f"{shape.name}|train_{name}"] = np.asarray(val)
    for i, leaf in enumerate(jax.tree.leaves((p1, o1))):
        out[f"{shape.name}|state{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
''' % (MESH, LR, EPS)


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
    path = tmp_path_factory.mktemp("jax_dimenet_mesh") / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def _port(name, devices=None):
    cfg = get_smoke("dimenet")[0]
    shape = SHAPES[name]
    mesh = make_test_mesh(*MESH, devices=devices or ["cpu"])
    params = jax.tree.map(np.asarray, jdn.init_params(jax.random.PRNGKey(0),
                                                      jax_get_smoke("dimenet")[0],
                                                      shape["d_feat"]))
    model = tdn.from_jax_params(params, cfg, shape["d_feat"], "cpu")
    batch = make_smoke_inputs(cfg, shape, mesh, seed=0)["batch"]
    return cfg, shape, mesh, model, batch


def _forward_and_train(jax_side, name, devices=None):
    """The forward's predictions and one train step against JAX's meshed
    run; returns the model and a forward."""
    cfg, shape, mesh, model, batch = _port(name, devices)
    n_nodes = shape["n_nodes"] * shape.dims.get("batch", 1)

    @torch.no_grad()
    def fwd():
        return tdn.forward(model, batch, n_nodes=n_nodes, d_feat=shape["d_feat"],
                           devices=list(mesh.devices))

    pred = fwd()
    np.testing.assert_allclose(pred.numpy(), jax_side[name + "|pred"], rtol=0, atol=FWD_ATOL)
    state = TrainState(model, adamw(model, LR, eps=EPS))
    state, metrics = build_bundle(cfg, mesh).step(shape).fn(state, batch)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), jax_side[f"{name}|train_{k}"], rtol=0,
                                   atol=TRAIN_ATOL, err_msg=k)
    for i, leaf in enumerate(state.leaves()):
        np.testing.assert_allclose(leaf.numpy(), jax_side[f"{name}|state{i}"], rtol=0,
                                   atol=TRAIN_ATOL, err_msg=state.leaf_names()[i])
    return model, fwd


@pytest.mark.parametrize("name", list(SHAPES))
def test_meshed_forward_and_train_step_match_jax(jax_side, name):
    _forward_and_train(jax_side, name)


@pytest.mark.parametrize("name", list(SHAPES))
def test_meshed_step_over_four_devices_matches_jax(jax_side, name):
    """Each of the four ranks on a device of its own (``_torch_replicas``):
    the ranks read the weights through replicas, and the forward and the
    train step match JAX's as on one device; the forward after the update
    reads the new weights."""
    model, fwd = _forward_and_train(jax_side, name, FOUR)
    fwd()
    check_replicas([model], fwd)


@pytest.mark.parametrize("name", list(SHAPES))
def test_ranks_hold_their_slices_and_the_ops_cross_ranks_as_the_reference(name):
    """Each rank's edge and triplet arrays are its contiguous slices; the
    meshed edge gather gives every rank the rank-order sum of the ranks'
    partial gathers (so over 4 ranks it differs from the one-rank gather);
    the node sum is the one-rank segment sum; the triplet sum stays within
    a rank; the bundle pads edges and triplets to a multiple of max(ranks,
    256)."""
    cfg, shape, mesh, model, batch = _port(name)
    devs = list(mesh.devices)
    sl = tdn.rank_slices(batch, devs)
    e_loc = batch["src"].shape[0] // 4
    t_loc = batch["trip_kj"].shape[0] // 4
    for r in range(4):
        assert torch.equal(sl["src"][r], batch["src"][r * e_loc:(r + 1) * e_loc])
        assert torch.equal(sl["trip_kj"][r], batch["trip_kj"][r * t_loc:(r + 1) * t_loc])
    feat = torch.randn(batch["src"].shape[0], 3, generator=torch.Generator().manual_seed(1))
    kj = batch["trip_kj"].long()
    got = tdn.sharded_edge_gather(list(feat.chunk(4)), list(kj.chunk(4)), devs)
    want = sum(torch.where(((k >= r * e_loc) & (k < (r + 1) * e_loc))[:, None],
                           feat[k.clamp(0, feat.shape[0] - 1)], 0.0)
               for r, k in enumerate(kj.chunk(4)))
    assert all(torch.allclose(g, want, atol=1e-6) for g in got)
    nodes = tdn.sharded_segment_to_nodes(list(feat.chunk(4)), list(batch["dst"].long().chunk(4)),
                                         int(batch["pos"].shape[0]), devs)
    one = torch.zeros(nodes.shape).index_add_(0, batch["dst"].long(), feat)
    assert torch.allclose(nodes, one, atol=1e-5)
    jl = list(batch["trip_ji_local"].long().chunk(4))
    assert all(int(j.max()) < e_loc for j in jl)
    edges = tdn.local_segment_to_edges(list(torch.ones(kj.shape[0], 1).chunk(4)), jl, e_loc)
    assert [tuple(e.shape) for e in edges] == [(e_loc, 1)] * 4
    spec = build_bundle(cfg, make_test_mesh(1, 512, device="cpu")).step(shape).input_specs
    assert spec["src"].shape[0] % 512 == 0 and spec["trip_kj"].shape[0] % 512 == 0
