"""The port's sharding rules, placement and pod-axis gradient compression
against the JAX package.

``logical_to_pspec`` and every arch's ``param_pspecs`` / ``cache_pspecs``
equal JAX's ``PartitionSpec`` as tuples over (1, 1), (1, 4), (2, 2) and
(pod 2, 1, 2) meshes (JAX's functions read only a mesh's axis names and
sizes, so they take a stand-in here). ``compressed_psum_pod`` is held against
JAX's over a 2-pod mesh of forced host devices, run once in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``): two steps with
error feedback, grads and error buffers within rtol 1e-6. The placement
helpers (``models.api``) keep whole leaves, so a checkpoint resumes on any
mesh.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_smoke as jax_get_smoke
from repro.distributed import sharding as jsh
from repro.models import dimenet as jdn
from repro.models import recsys as jrs
from repro.models import transformer as jtr
from repro_torch.configs import get_smoke
from repro_torch.distributed import LOGICAL_RULES, batch_axes, logical_to_pspec, seq_axis
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle
from repro_torch.models import dimenet as tdn
from repro_torch.models import recsys as trs
from repro_torch.models import transformer as ttr
from repro_torch.models.api import TrainState, adamw
from repro_torch.train import grad_compress as tgc

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
MESHES = ((1, 1, 0), (1, 4, 0), (2, 2, 0), (1, 2, 2))     # (data, model, pod)
LM_ARCHS = JAX_ARCH_IDS[:5]


def _jmesh(data, model, pod):
    names = ("pod", "data", "model") if pod else ("data", "model")
    sizes = (pod, data, model) if pod else (data, model)
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def _tuples(tree):
    """A pspec tree (JAX P or port tuples) as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_pspecs_equal_jax(dims):
    jm = _jmesh(*dims)
    tm = make_test_mesh(*dims, device="cpu")
    assert LOGICAL_RULES == jsh.LOGICAL_RULES
    assert batch_axes(tm) == jsh.batch_axes(jm) and seq_axis(tm) == jsh.seq_axis(jm)
    for axes in (("batch", "seq", None), ("flat_batch",), ("stack", "fsdp", "mlp"),
                 ("expert", "rows", "vocab", "heads_flat", "embed", "kv", "unknown")):
        assert logical_to_pspec(axes, tm) == tuple(jsh.logical_to_pspec(axes, jm))
    for arch in LM_ARCHS:
        jcfg, tcfg = jax_get_smoke(arch)[0], get_smoke(arch)[0]
        assert _tuples(ttr.param_pspecs(tcfg, tm)) == _tuples(jtr.param_pspecs(jcfg, jm)), arch
        for gb in (1, 2, 4):
            assert _tuples(ttr.cache_pspecs(tcfg, tm, gb)) == \
                _tuples(jtr.cache_pspecs(jcfg, jm, gb)), (arch, gb)
    for arch in ("deepfm", "autoint", "mind", "dlrm-rm2"):
        jcfg, tcfg = jax_get_smoke(arch)[0], get_smoke(arch)[0]
        assert _tuples(trs.param_pspecs(tcfg, tm)) == _tuples(jrs.param_pspecs(jcfg, jm)), arch
    jcfg, tcfg = jax_get_smoke("dimenet")[0], get_smoke("dimenet")[0]
    for d_feat in (0, 16):
        assert _tuples(tdn.param_pspecs(tcfg, d_feat, tm)) == \
            _tuples(jdn.param_pspecs(jcfg, d_feat, jm))
    if dims[2] == 0:
        assert _tuples(build_bundle(get_smoke("dlrm-rm2")[0], tm).param_pspecs()) == \
            _tuples(jrs.param_pspecs(jax_get_smoke("dlrm-rm2")[0], jm))


def test_checkpoint_leaves_are_whole_on_any_mesh():
    """A meshed LM's and recsys model's ``TrainState`` lists the reference's
    whole leaves in its order: equal to the one-rank state's after the same
    load, and a state written by one mesh loads into another."""
    for arch in ("moonshot-v1-16b-a3b", "mistral-large-123b"):
        cfg = dataclasses.replace(get_smoke(arch)[0], dtype="float32", ffn_impl="sp")
        one = ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        s1 = TrainState(one, adamw(one, 1e-3))
        for dims in ((1, 2), (2, 2)):
            model = ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                    mesh=make_test_mesh(*dims, device="cpu"))
            assert model.splits                  # the experts or the FFN are cut
            sm = TrainState(model, adamw(model, 1e-3))
            assert sm.leaf_names() == s1.leaf_names()
            for a, b in zip(s1.leaves(), sm.leaves()):
                assert torch.equal(a, b)
            shifted = [t + 1 if t.is_floating_point() else t for t in s1.leaves()]
            sm.load_leaves(shifted)
            for a, b in zip(shifted, sm.leaves()):
                assert torch.equal(a, b)
    cfg = get_smoke("deepfm")[0]
    one = trs.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    meshed = trs.init_params(cfg, torch.Generator().manual_seed(0),
                             mesh=make_test_mesh(1, 4, device="cpu"))
    s1, sm = TrainState(one, adamw(one, 1e-3)), TrainState(meshed, adamw(meshed, 1e-3))
    assert s1.leaf_names() == sm.leaf_names()
    assert all(torch.equal(a, b) for a, b in zip(s1.leaves(), sm.leaves()))
    assert len(sm.tx.params) == len(s1.tx.params) + 2 * 3      # tables and wide in 4 slices


JAX_PSUM = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_test_mesh
from repro.train import grad_compress as gc

mesh = make_test_mesh(1, 1, pod=2)
rng = np.random.default_rng(0)
grads = [{"a": jnp.asarray(rng.normal(0, s, (33, 7)).astype(np.float32)),
          "b": jnp.asarray(rng.normal(0, s, (5,)).astype(np.float32))} for s in (1.0, 1e-3)]
err = gc.init_error_buffers(grads[0])
out = {}
for i, g in enumerate(grads):
    red, err = gc.compressed_psum_pod(g, err, mesh)
    for k in ("a", "b"):
        out[f"{i}|red|{k}"] = np.asarray(red[k])
        out[f"{i}|err|{k}"] = np.asarray(err[k])
        out[f"{i}|grad|{k}"] = np.asarray(g[k])
ratio = gc.compression_ratio_bytes(grads[0])
out["ratio"] = np.asarray([ratio["f32_bytes"], ratio["int8_bytes"], ratio["ratio"]])
np.savez(sys.argv[1], **out)
'''


def test_compressed_psum_pod_matches_jax(tmp_path):
    path = tmp_path / "psum.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", JAX_PSUM, str(path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = dict(np.load(path))
    mesh = make_test_mesh(1, 1, pod=2, device="cpu")
    grads = [[torch.from_numpy(want[f"{i}|grad|{k}"]) for k in ("a", "b")] for i in range(2)]
    err = [tgc.init_error_buffers(grads[0])] * 2          # the reference's: one tree a rank
    for i, g in enumerate(grads):
        red, err = tgc.compressed_psum_pod([g, g], err, mesh)
        assert all(torch.equal(a, b) for a, b in zip(*err))
        for k, r, e in zip(("a", "b"), red, err[0]):
            np.testing.assert_allclose(r.numpy(), want[f"{i}|red|{k}"], rtol=1e-6, atol=0)
            np.testing.assert_allclose(e.numpy(), want[f"{i}|err|{k}"], rtol=1e-6, atol=1e-12)
    ratio = tgc.compression_ratio_bytes(grads[0])
    np.testing.assert_array_equal([ratio["f32_bytes"], ratio["int8_bytes"], ratio["ratio"]],
                                  want["ratio"])


def test_compressed_psum_pod_rank_by_rank():
    """Each pod rank quantizes its own g + e (scale max|x| / 127, round half
    to even), keeps x − deq, and the ranks' dequantized tensors are averaged
    in rank order."""
    mesh = make_test_mesh(1, 1, pod=2, device="cpu")
    x = torch.tensor([0.5, 1.5, -2.5, 127.0])
    q, scale = tgc._quantize(x)
    assert float(scale) == pytest.approx(1.0) and q.tolist() == [0, 2, -2, 127]
    gen = torch.Generator().manual_seed(0)
    g = [[torch.randn(6, 5, generator=gen), torch.randn(3, generator=gen)] for _ in range(2)]
    e = [[torch.randn(6, 5, generator=gen) * 1e-3, torch.zeros(3)] for _ in range(2)]
    red, new = tgc.compressed_psum_pod(g, e, mesh)
    for i in range(2):
        deq = []
        for p in range(2):
            xp = g[p][i] + e[p][i]
            qp, sp = tgc._quantize(xp)
            deq.append(qp.float() * sp)
            assert torch.equal(new[p][i], xp - deq[-1])
        assert torch.equal(red[i], (deq[0] + deq[1]) / 2)
    with pytest.raises(ValueError, match="for 2 pod ranks"):
        tgc.compressed_psum_pod(g[:1], e[:1], mesh)
    assert [tuple(t.shape) for t in tgc.init_error_buffers(g[0])] == [(6, 5), (3,)]
