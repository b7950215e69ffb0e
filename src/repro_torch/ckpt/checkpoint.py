"""Writer and reader of the step directories ``repro/ckpt/checkpoint.py``
writes: ``<dir>/step_<N:010d>/manifest.json``
plus one ``leaf_<i:05d>.p<proc>.npy`` per flattened leaf, ``<dir>/LATEST``
naming the newest step. The leaf order is JAX's flatten order, which the
caller reconstructs (``serving.engine._jax_leaf_names``); this module writes
the leaves it is given in that order and checks each leaf it reads against
the manifest.

Saving is crash-safe at every point: the leaves and the manifest go to
``step_N.tmp/`` (each file fsynced), which is renamed to ``step_N`` at once;
``LATEST`` is replaced through a rename too; the oldest steps beyond
``keep`` are removed. A crash mid-write leaves only a ``.tmp`` directory,
which readers ignore and the next save of that step replaces.
``CheckpointManager.restore`` reads the newest complete step back into a
template's dtypes and devices, so a directory either package wrote resumes
in the other.

npy has no bfloat16. ``save`` writes a bfloat16 tensor upcast to f32
(exact), which the reference's ``restore`` casts back to its template's
bfloat16. The reference writes a bfloat16 leaf as raw 2-byte records (a
``|V2`` npy) beside the manifest dtype "bfloat16"; ``load_leaves`` reads
those bits as bfloat16 and returns them as f32 (exact), so ``restore`` gives
them back bit for bit. (The reference's own ``restore`` cannot cast such a
file: it raises on its ``astype``.)
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Optional, Sequence

import numpy as np
import torch


class CheckpointManager:
    """Step-numbered checkpoints under ``directory``, the newest ``keep``
    retained. One process writes them, so every leaf file carries ``.p0``."""

    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, leaves: Sequence, extra: Optional[dict] = None,
             treedef: str = "") -> pathlib.Path:
        """Write ``leaves`` (arrays or tensors on any device, in flatten
        order) and ``extra`` (JSON) as step ``step``; returns the step
        directory."""
        leaves = [np.asarray(_host(leaf) if isinstance(leaf, torch.Tensor) else leaf, order="C")
                  for leaf in leaves]
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta = {"step": step, "treedef": treedef, "n_leaves": len(leaves),
                "dtypes": [str(leaf.dtype) for leaf in leaves],
                "shapes": [list(leaf.shape) for leaf in leaves],
                "extra": extra or {}}
        for i, leaf in enumerate(leaves):
            with open(tmp / f"leaf_{i:05d}.p0.npy", "wb") as f:
                np.save(f, leaf)
                f.flush()
                os.fsync(f.fileno())
        with open(tmp / "manifest.json", "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)                      # atomic commit
        latest = self.dir / "LATEST.tmp"
        latest.write_text(str(step))
        os.rename(latest, self.dir / "LATEST")
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
        return final

    def all_steps(self) -> list:
        return all_steps(self.dir)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.dir)

    def restore(self, template: Sequence, step: Optional[int] = None):
        """(leaves, step, extra) of ``step`` (default: the newest complete
        one), or (None, None, None) when there is none. ``template`` lists
        one leaf per saved leaf, in flatten order: each comes back in its
        template leaf's dtype, a tensor on the template tensor's device or
        a numpy array for an array, and must have its shape."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        step_dir, meta = read_manifest(self.dir, step)
        if len(template) != meta["n_leaves"]:
            raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, template has "
                             f"{len(template)}")
        leaves = []
        for i, (tl, arr) in enumerate(zip(template, load_leaves(step_dir, meta))):
            if tuple(np.shape(tl)) != arr.shape:
                raise ValueError(f"leaf {i}: checkpoint holds {arr.shape}, template "
                                 f"{tuple(np.shape(tl))}")
            if isinstance(tl, torch.Tensor):
                leaves.append(torch.from_numpy(np.asarray(arr, order="C")).to(
                    device=tl.device, dtype=tl.dtype))
            else:
                leaves.append(arr.astype(np.asarray(tl).dtype))
        return leaves, step, meta["extra"]


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bfloat16 upcast to f32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _bf16_bits_to_f32(arr: np.ndarray) -> np.ndarray:
    """Raw bfloat16 records (2 bytes each) as the f32 values they hold: the
    bits are the top half of the f32's."""
    bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def all_steps(directory) -> list:
    """Complete steps under ``directory`` (a step directory counts once its
    manifest exists), ascending."""
    steps = []
    for p in pathlib.Path(directory).iterdir():
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
            if (p / "manifest.json").exists():
                steps.append(int(p.name.split("_")[1]))
    return sorted(steps)


def latest_step(directory) -> Optional[int]:
    """Newest complete step under ``directory``, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


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
    dtype; a bfloat16 leaf written as 2-byte records comes back as f32."""
    leaves = []
    for i in range(meta["n_leaves"]):
        arr = np.load(pathlib.Path(step_dir) / f"leaf_{i:05d}.p{proc}.npy")
        if meta["dtypes"][i] == "bfloat16" and arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            if list(arr.shape) != list(meta["shapes"][i]):
                raise ValueError(f"leaf {i}: file holds {list(arr.shape)}, manifest says "
                                 f"{meta['shapes'][i]}")
            leaves.append(_bf16_bits_to_f32(arr))
            continue
        if list(arr.shape) != list(meta["shapes"][i]) or str(arr.dtype) != meta["dtypes"][i]:
            raise ValueError(f"leaf {i}: file holds {arr.dtype}{list(arr.shape)}, manifest "
                             f"says {meta['dtypes'][i]}{meta['shapes'][i]}")
        leaves.append(arr)
    return leaves
