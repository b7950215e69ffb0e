"""Training launcher (counterpart of ``python -m repro.launch.train``): an LM
or recsys architecture's SMOKE config at its train shape through the port's
substrate (the bundle's train step and optimizer, ``Trainer``, atomic
checkpoints, the resumable ``TokenPipeline`` or ``RecsysPipeline``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --device cpu

It runs on the card unless ``--device cpu`` is given. The step updates the
parameters with the bundle's own AdamW, as the reference's step does (its
launcher's ``adamw(1e-3)`` only shapes the state); a checkpoint every 50
steps (keep 2) under ``--ckpt-dir`` (default ``build/lm_train_ckpt`` in the
checkout), from which a restart resumes. ``--fail-at N`` raises after step
N's update, before its checkpoint. As in the reference, ``dimenet`` exits
(its batches come from the examples and benchmarks), and ``mind`` stops at
its first step: ``RecsysPipeline`` yields no ``hist_ids``.
"""
from __future__ import annotations

import argparse
import pathlib

CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "lm_train_ckpt"


def main(argv=None) -> list:
    """Trains to ``--steps`` (resuming from ``--ckpt-dir``); returns the
    history."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash at this step (restart resumes)")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import canon, get_smoke
    from repro_torch.configs.base import LMConfig, RecsysConfig
    from repro_torch.data.pipeline import PipelineSpec, RecsysPipeline, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models.api import TrainState
    from repro_torch.train.trainer import Trainer

    smoke, shapes = get_smoke(canon(args.arch))
    if isinstance(smoke, LMConfig):
        shape = next(s for s in shapes if "train" in s.kind)
        pipeline = TokenPipeline(PipelineSpec(global_batch=shape["global_batch"]),
                                 seq_len=shape["seq_len"], vocab=smoke.vocab)
    elif isinstance(smoke, RecsysConfig):
        shape = next(s for s in shapes if "train" in s.kind)
        pipeline = RecsysPipeline(PipelineSpec(global_batch=shape["batch"]), smoke)
    else:
        raise SystemExit(f"use examples/ or benchmarks for arch {args.arch}")
    mesh = make_test_mesh(device=args.device)
    bundle = build_bundle(smoke, mesh)
    sd = bundle.step(shape)
    model = bundle.init(torch.Generator(mesh.devices[0]).manual_seed(0), shape)
    state = TrainState(model, bundle.optimizer(model))
    trainer = Trainer(sd.fn, state, pipeline,
                      ckpt_manager=CheckpointManager(args.ckpt_dir, keep=2),
                      ckpt_every=50, log_every=10)
    print(f"{args.arch}: starting at step {trainer.start_step}")
    _, history = trainer.run(args.steps, fail_at=args.fail_at)
    for h in history[-3:]:
        print(h)
    return history


if __name__ == "__main__":
    main()
