"""Numpy-only reader of the step directories ``repro/ckpt/checkpoint.py``
writes: ``<dir>/step_<N:010d>/manifest.json`` plus one
``leaf_<i:05d>.p<proc>.npy`` per flattened leaf, ``<dir>/LATEST`` naming the
newest step. The leaf order is JAX's flatten order, which the caller
reconstructs; this module only checks each leaf against the manifest."""
from __future__ import annotations

import json
import pathlib
from typing import Optional

import numpy as np


def latest_step(directory) -> Optional[int]:
    """Newest complete step under ``directory`` (a step directory counts
    once its manifest exists), or None."""
    steps = []
    for p in pathlib.Path(directory).iterdir():
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
            if (p / "manifest.json").exists():
                steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def read_manifest(directory, step: Optional[int] = None):
    """(step directory, manifest dict) of ``step`` (default: the newest)."""
    directory = pathlib.Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"no checkpoint under {directory}")
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    step_dir = directory / f"step_{step:010d}"
    return step_dir, json.loads((step_dir / "manifest.json").read_text())


def load_leaves(step_dir, meta: dict, proc: int = 0) -> list:
    """Every leaf of the step, each checked against the manifest's shape and
    dtype."""
    leaves = []
    for i in range(meta["n_leaves"]):
        arr = np.load(pathlib.Path(step_dir) / f"leaf_{i:05d}.p{proc}.npy")
        if list(arr.shape) != list(meta["shapes"][i]) or str(arr.dtype) != meta["dtypes"][i]:
            raise ValueError(f"leaf {i}: file holds {arr.dtype}{list(arr.shape)}, manifest "
                             f"says {meta['dtypes'][i]}{meta['shapes'][i]}")
        leaves.append(arr)
    return leaves
