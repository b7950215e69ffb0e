"""Training loop with checkpoint/restart fault tolerance; counterpart of
``repro/train/trainer.py``.

The Trainer is deliberately simple and crash-safe:
  * the state is a flat list of tensors; batches come from a step-indexed
    pipeline (a pure function of step, so nothing to checkpoint on the data
    side);
  * it checkpoints every ``ckpt_every`` steps through the atomic
    ``CheckpointManager``;
  * on construction it resumes from the newest complete checkpoint;
  * a simulated failure (``fail_at``) loses at most ``ckpt_every`` steps,
    which the restart replays deterministically.

PyTorch updates parameters in place, so a restored checkpoint is copied
into ``init_state``'s own tensors: a step function that updates a model and
an optimizer in place (whose tensors ``init_state`` lists, as
``core.train_probing.train_state`` gives them) resumes from the restored
values. A step function that returns new tensors works as well.

Where the checkpoint's layout is not the live tensors' (the LM's layers are
stacked [L, ...] in the reference's tree and held a layer each here),
``init_state`` is a state object instead of a list: ``leaves()`` lists what
a checkpoint holds, ``load_leaves(leaves)`` copies a restored list back, and
``device`` names where batches go (``models.api.TrainState``).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch


class Trainer:
    def __init__(
        self,
        step_fn: Callable,                 # (state, batch) -> (state, metrics)
        init_state,                        # flat list of tensors, or a state object
                                           # (leaves, load_leaves, device)
        pipeline,                          # .batch_at(step) -> dict of np arrays
        ckpt_manager=None,
        ckpt_every: int = 50,
        log_every: int = 10,
    ):
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        listed = not hasattr(init_state, "load_leaves")
        self.device = next((t.device for t in init_state if isinstance(t, torch.Tensor)
                            and t.ndim > 0), torch.device("cpu")) if listed else init_state.device
        self.history: list[dict] = []

        self.state = init_state
        self.start_step = 0
        if self.ckpt is not None:
            restored, step, extra = self.ckpt.restore(_leaves(init_state))
            if restored is not None:
                if listed:
                    with torch.no_grad():
                        for dst, src in zip(init_state, restored):
                            dst.copy_(src)
                else:
                    init_state.load_leaves(restored)
                self.start_step = step
                self.history = extra.get("history", [])

    def run(self, n_steps: int, fail_at: Optional[int] = None):
        """Train to global step ``n_steps``. ``fail_at`` raises mid-run after
        the optimizer update but before the checkpoint (the worst crash
        point), for the fault-tolerance tests."""
        step = self.start_step
        t0 = time.time()
        while step < n_steps:
            batch = {n: torch.as_tensor(v, device=self.device)
                     for n, v in self.pipeline.batch_at(step).items()}
            self.state, metrics = self.step_fn(self.state, batch)
            step += 1
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"simulated failure at step {step}")
            if step % self.log_every == 0 or step == n_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["steps_per_s"] = round(self.log_every / max(time.time() - t0, 1e-9), 3)
                t0 = time.time()
                self.history.append(m)
            if self.ckpt is not None and (step % self.ckpt_every == 0 or step == n_steps):
                self.ckpt.save(step, _leaves(self.state), extra={"history": self.history[-200:]})
        self.start_step = step
        return self.state, self.history


def _leaves(state) -> list:
    """What a checkpoint of ``state`` holds: a list state itself, or a state
    object's ``leaves()``."""
    return state.leaves() if hasattr(state, "load_leaves") else state
