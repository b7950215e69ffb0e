"""Train a small LM for a few hundred steps with the full substrate
(counterpart of ``examples/lm_pretrain.py``): the same transformer, config,
trainer, checkpoint and pipeline stack that trains stablelm-3b on the card,
here at ~3M parameters.

    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain [--steps 200] [--moe]
    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain --device cpu

It runs on the card unless ``--device cpu`` is given. Checkpoints go to
``--ckpt-dir`` (default ``build/lm_pretrain_ckpt`` in the checkout); a rerun
resumes from them.
"""
from __future__ import annotations

import argparse
import pathlib

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.data.pipeline import PipelineSpec, TokenPipeline
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle, transformer
from repro_torch.models.api import ShapeSpec
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer

CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "lm_pretrain_ckpt"


def main(device=None, *, steps: int = 200, moe: bool = False, ckpt_dir=CKPT_DIR,
         seq_len: int = 128, global_batch: int = 16) -> list:
    """Trains to ``steps`` (resuming from ``ckpt_dir``); returns the history.
    Raises unless the loss fell."""
    cfg = LMConfig(
        arch="lm-3m", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=384, vocab=2048, attn_block=64,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=128) if moe else None,
    )
    mesh = make_test_mesh(data=1, model=1, device=device)
    bundle = build_bundle(cfg, mesh)
    shape = ShapeSpec("train_sm", "train", {"seq_len": seq_len, "global_batch": global_batch})
    sd = bundle.step(shape)
    model = bundle.init(torch.Generator(mesh.devices[0]).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f}M  (moe={bool(cfg.moe)})")

    tx = transformer.adamw(model, opt.cosine_schedule(3e-3, 20, steps))
    pipeline = TokenPipeline(PipelineSpec(global_batch=global_batch, seed=0), seq_len=seq_len,
                             vocab=cfg.vocab)
    trainer = Trainer(sd.fn, transformer.TrainState(model, tx), pipeline,
                      ckpt_manager=CheckpointManager(ckpt_dir, keep=2),
                      ckpt_every=100, log_every=20)
    _, history = trainer.run(steps)
    first, last = history[0], history[-1]
    print(f"loss {first['loss']:.3f} (step {first['step']}) → {last['loss']:.3f} "
          f"(step {last['step']})")
    if not last["loss"] < first["loss"]:
        raise AssertionError("LM did not learn")
    print("ok")
    return history


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--moe", action="store_true", help="use a tiny MoE variant")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    a = ap.parse_args()
    main(a.device, steps=a.steps, moe=a.moe, ckpt_dir=a.ckpt_dir)
