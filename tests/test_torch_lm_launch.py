"""The port's training launcher (``python -m repro_torch.launch.train``,
counterpart of ``repro.launch.train``) and LM pre-training example
(``repro_torch.examples.lm_pretrain``, counterpart of
``examples/lm_pretrain.py``) on the CPU: the LM and recsys SMOKE configs
train, a run that crashes after an update and restarts from its checkpoint
ends bit-equal to an uninterrupted run (the final checkpoints' files
compared), dimenet and mind stop as they do in the reference's launcher,
and the example's loss falls at reduced sizes, dense and MoE. On the card
they run as ``python -m`` (``chip_smoke.py`` phases 21 and 22)."""
import math
import re
import sys

import pytest
import torch

from repro_torch.ckpt.checkpoint import load_leaves, read_manifest
from repro_torch.examples import lm_pretrain
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these models are tiny, and beside other test
    workers on the machine a pool of spinning threads makes their steps
    tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["stablelm-3b", "moonshot-v1-16b-a3b"])
def test_launcher_trains_the_smoke_config(tmp_path, capsys, arch):
    hist = train.main(["--arch", arch, "--steps", "20", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith(f"{arch}: starting at step 0")
    assert [h["step"] for h in hist] == [10, 20]
    assert all(math.isfinite(h[k]) for h in hist for k in ("loss", "ce", "moe_aux", "grad_norm"))
    assert (hist[-1]["moe_aux"] > 0) == (arch != "stablelm-3b")
    assert len(re.findall(r"^\{'loss'", text, re.M)) == 2
    _, meta = read_manifest(tmp_path)
    assert meta["step"] == 20 and "float32" in meta["dtypes"]      # bf16 leaves upcast


def test_launcher_restart_ends_where_an_uninterrupted_run_ends(tmp_path, capsys):
    """--fail-at 55 raises after step 55's update (the checkpoint of step 50
    stands); the restart resumes at 50 and its step-60 checkpoint is the
    uninterrupted run's, file for file."""
    args = ["--arch", "stablelm-3b", "--steps", "60", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="simulated failure at step 55"):
        train.main(args + ["--ckpt-dir", str(tmp_path / "a"), "--fail-at", "55"])
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert "stablelm-3b: starting at step 50" in capsys.readouterr().out
    gold = train.main(args + ["--ckpt-dir", str(tmp_path / "b")])

    def logged(hist):
        return [(h["step"], h["loss"], h["grad_norm"]) for h in hist]

    assert [h["step"] for h in gold] == [10, 20, 30, 40, 50, 60]
    assert logged(resumed) == logged(gold)
    leaves = {}
    for run in ("a", "b"):
        step_dir, meta = read_manifest(tmp_path / run)
        assert meta["step"] == 60
        leaves[run] = load_leaves(step_dir, meta)
    assert len(leaves["a"]) == len(leaves["b"]) > 0
    for x, y in zip(leaves["a"], leaves["b"]):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("arch", ["deepfm", "dlrm-rm2"])
def test_recsys_launcher_restart_ends_where_an_uninterrupted_run_ends(tmp_path, capsys, arch):
    """A recsys SMOKE config trains through the launcher (RecsysPipeline
    batches); --fail-at 55 and a restart from step 50 end in the
    uninterrupted run's step-60 checkpoint, file for file."""
    args = ["--arch", arch, "--steps", "60", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="simulated failure at step 55"):
        train.main(args + ["--ckpt-dir", str(tmp_path / "a"), "--fail-at", "55"])
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert f"{arch}: starting at step 50" in capsys.readouterr().out
    gold = train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert [h["step"] for h in gold] == [10, 20, 30, 40, 50, 60]
    assert all(math.isfinite(h[k]) for h in gold for k in ("loss", "grad_norm"))
    assert [(h["step"], h["loss"], h["grad_norm"]) for h in resumed] == \
        [(h["step"], h["loss"], h["grad_norm"]) for h in gold]
    leaves = []
    for run in ("a", "b"):
        step_dir, meta = read_manifest(tmp_path / run)
        assert meta["step"] == 60
        leaves.append(load_leaves(step_dir, meta))
    assert len(leaves[0]) == len(leaves[1]) > 0
    for x, y in zip(*leaves):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _jax_launcher(monkeypatch, arch, ckpt_dir):
    from repro.launch import train as jax_train

    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--steps", "2",
                                      "--ckpt-dir", str(ckpt_dir)])
    return jax_train.main


def test_launcher_exits_for_dimenet_as_the_reference(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="benchmarks for arch dimenet"):
        train.main(["--arch", "dimenet", "--ckpt-dir", str(tmp_path / "t"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="benchmarks for arch dimenet"):
        _jax_launcher(monkeypatch, "dimenet", tmp_path / "j")()


def test_launcher_fails_on_mind_as_the_reference(tmp_path, monkeypatch):
    """RecsysPipeline yields no MIND history, in either package: the first
    step stops on the missing hist_ids."""
    with pytest.raises(KeyError, match="hist_ids"):
        train.main(["--arch", "mind", "--ckpt-dir", str(tmp_path / "t"), "--device", "cpu"])
    with pytest.raises(KeyError, match="hist_ids"):
        _jax_launcher(monkeypatch, "mind", tmp_path / "j")()


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_lm_pretrain_learns(tmp_path, capsys, moe):
    hist = lm_pretrain.main("cpu", steps=40, moe=moe, ckpt_dir=tmp_path, seq_len=64,
                            global_batch=8)
    text = capsys.readouterr().out
    assert re.search(rf"params: [\d.]+M  \(moe={moe}\)", text)
    assert re.search(r"loss [\d.]+ \(step 20\) → [\d.]+ \(step 40\)", text)
    assert text.rstrip().endswith("ok")
    assert [h["step"] for h in hist] == [20, 40] and hist[-1]["loss"] < hist[0]["loss"]
