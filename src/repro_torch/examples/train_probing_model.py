"""Fault-tolerant training of the probing model (counterpart of
``examples/train_probing_model.py``): Trainer + atomic checkpoints +
deterministic resumable pipeline. Kill it mid-run and re-run it: it resumes
from the last checkpoint and ends in the same state.

    PYTHONPATH=src python -m repro_torch.examples.train_probing_model                 # on the card
    PYTHONPATH=src python -m repro_torch.examples.train_probing_model --device cpu

The checkpoints go to ``--ckpt-dir`` (default ``build/lira_probe_ckpt`` in the
checkout), in the layout the reference writes: a directory either package
wrote resumes in the other.
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core import ground_truth as gt
from repro_torch.core import probing
from repro_torch.core.kmeans import centroid_distances, kmeans_fit
from repro_torch.core.train_probing import make_train_step, train_state
from repro_torch.data.pipeline import PipelineSpec, ProbingPipeline
from repro_torch.data.synthetic import make_vector_dataset
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer
from repro_torch.utils.device import resolve_device

CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "lira_probe_ckpt"


def main(device=None, *, ckpt_dir=CKPT_DIR, n: int = 20_000, n_train: int = 6_000,
         steps: int = 600) -> list:
    """Trains to ``steps`` (resuming from ``ckpt_dir``); returns the history."""
    dev = resolve_device(device)
    b, k = 32, 10
    ds = make_vector_dataset(n=n, n_queries=100, dim=64, n_modes=64, seed=3)
    base = torch.as_tensor(ds.base, device=dev)
    st = kmeans_fit(base, b, n_iters=12, generator=torch.Generator(dev).manual_seed(0))
    assign = st.assign.cpu().numpy()

    sub = np.random.default_rng(0).choice(len(ds.base), n_train, replace=False)
    xs = ds.base[sub]
    _, sti = gt.exact_knn(xs, xs, k, exclude_self=True, device=dev)
    lab = np.zeros((len(sub), b), np.float32)
    np.add.at(lab, (np.repeat(np.arange(len(sub)), k), assign[sub][sti].reshape(-1)), 1.0)
    lab = (lab > 0).astype(np.float32)
    with torch.no_grad():
        cd = centroid_distances(base[torch.as_tensor(sub, device=dev)], st.centroids).cpu().numpy()

    pc = probing.ProbingConfig(dim=xs.shape[1], n_partitions=b)
    model = probing.ProbingModel(pc, generator=torch.Generator(dev).manual_seed(1), device=dev)
    tx = opt.AdamW(model.parameters(), opt.cosine_schedule(2e-3, 50, 2000))

    pipeline = ProbingPipeline(PipelineSpec(global_batch=256, seed=0), xs, cd, lab)
    trainer = Trainer(make_train_step(model, tx), train_state(model, tx), pipeline,
                      ckpt_manager=CheckpointManager(ckpt_dir, keep=3),
                      ckpt_every=100, log_every=50)
    print(f"starting at step {trainer.start_step} (0 = fresh, >0 = resumed)")
    _, history = trainer.run(steps)
    for h in history[-4:]:
        print(h)
    return history


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    a = ap.parse_args()
    main(a.device, ckpt_dir=a.ckpt_dir)
