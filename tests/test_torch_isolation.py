"""The port stands alone: no module under ``src/repro_torch/`` imports jax or
the JAX package, importing it leaves jax unloaded, and its entry points
refuse to run on the CPU unless asked to (or handed CPU tensors)."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for part in ("launch/mesh.py", "launch/serve.py", "distributed/fault.py",
                 "serving/cluster.py", "core/retrieval.py", "core/baselines.py",
                 "data/pipeline.py", "train/trainer.py", "examples/serve_ann.py",
                 "examples/quickstart.py", "examples/train_probing_model.py",
                 "models/api.py", "models/layers.py", "models/transformer.py",
                 "configs/stablelm_3b.py", "configs/deepseek_coder_33b.py",
                 "configs/mistral_large_123b.py", "configs/moonshot_v1_16b_a3b.py",
                 "configs/qwen3_moe_235b_a22b.py", "data/smoke.py"):
        assert PKG / part in files
    bad = [(str(f.relative_to(PKG)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, repro_torch.serving.engine, repro_torch.kernels.ops, "
            "repro_torch.configs.lira_ann, repro_torch.configs.lira_ann_q, "
            "repro_torch.serving.quantized, repro_torch.core.pq, repro_torch.data.synthetic, "
            "repro_torch.serving.frontend, repro_torch.serving.mutable, repro_torch.obs, "
            "repro_torch.utils.clock, repro_torch.ckpt.checkpoint, repro_torch.launch.mesh, "
            "repro_torch.launch.serve, repro_torch.distributed, repro_torch.serving.cluster, "
            "repro_torch.core.retrieval, repro_torch.core.baselines, repro_torch.data.pipeline, "
            "repro_torch.train.trainer, repro_torch.examples.serve_ann, "
            "repro_torch.examples.quickstart, repro_torch.examples.train_probing_model, "
            "repro_torch.models, repro_torch.models.api, repro_torch.models.layers, "
            "repro_torch.models.transformer, repro_torch.configs, repro_torch.data.smoke, "
            "repro_torch.configs.stablelm_3b, repro_torch.configs.deepseek_coder_33b, "
            "repro_torch.configs.mistral_large_123b, repro_torch.configs.moonshot_v1_16b_a3b, "
            "repro_torch.configs.qwen3_moe_235b_a22b; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.examples import quickstart, serve_ann, train_probing_model
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serving.api import BuildConfig
    from repro_torch.serving.cluster import ClusterConfig, LiraCluster
    from repro_torch.serving.engine import LiraEngine
    from repro_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiraEngine.build(x, BuildConfig(n_partitions=4, k=5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiraEngine.load_jax("/nonexistent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiraEngine.load("/nonexistent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_test_mesh(model=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiraCluster.build(x, BuildConfig(n_partitions=4, k=5), ClusterConfig(n_shards=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main([])
    for example in (quickstart, serve_ann, train_probing_model):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            example.main()
    assert resolve_device("cpu") == torch.device("cpu")
    assert make_test_mesh(model=2, device="cpu").devices == (torch.device("cpu"),) * 2


def _entry_points():
    from repro_torch.core import baselines
    from repro_torch.core import ground_truth as gt
    from repro_torch.core import probing
    from repro_torch.core.partitions import build_store
    from repro_torch.core.train_probing import train_probing_model

    x = np.random.default_rng(1).normal(size=(32, 8)).astype(np.float32)
    ids, assign = np.arange(32, dtype=np.int32), np.arange(32, dtype=np.int32) % 4
    tree = {"phi_q": [{"w": np.zeros((8, 16), np.float32), "b": np.zeros(16, np.float32)}],
            "phi_i": [{"w": np.zeros((4, 8), np.float32), "b": np.zeros(8, np.float32)}],
            "phi_p": [{"w": np.zeros((24, 4), np.float32), "b": np.zeros(4, np.float32)}]}
    return x, {
        "exact_knn": lambda x: gt.exact_knn(x[:4], x, 3),
        "build_store": lambda x: build_store(x, ids, assign, x[:4]),
        "train_probing_model": lambda x: train_probing_model(
            x, np.zeros((32, 4), np.float32), x[:4], epochs=1, batch=16),
        "params_from_jax": lambda x: probing.params_from_jax(tree),
        "ProbingModel": lambda x: probing.ProbingModel(probing.ProbingConfig(dim=8, n_partitions=4)),
        "build_ivf": lambda x: baselines.build_ivf(x, 4, generator=torch.Generator()),
        "build_bliss": lambda x: baselines.build_bliss(x, 4, n_groups=1, reparts=1, epochs=1,
                                                       generator=torch.Generator()),
    }


@pytest.mark.parametrize("entry", ["exact_knn", "build_store", "train_probing_model",
                                   "params_from_jax", "ProbingModel", "build_ivf",
                                   "build_bliss"])
def test_entry_point_on_arrays_without_device_raises_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, entry_points = _entry_points()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry_points[entry](x)


def test_entry_points_follow_the_tensors_they_are_given(monkeypatch):
    """CPU tensors are the caller's choice of device: no card is needed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, entry_points = _entry_points()
    d, i = entry_points["exact_knn"](torch.from_numpy(x))
    assert d.shape == i.shape == (4, 3) and (i[:, 0] == np.arange(4)).all()
    store = entry_points["build_store"](torch.from_numpy(x))
    assert store.vectors.device.type == "cpu" and int(store.counts.sum()) == 32
    from repro_torch.core import retrieval
    assert retrieval.partition_topk(store, x[:3], 2).dists.shape == (3, 4, 2)
    assert entry_points["build_ivf"](torch.from_numpy(x)).vectors.device.type == "cpu"
