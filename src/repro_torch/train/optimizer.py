"""AdamW, SGD, the cosine schedule and global-norm clipping with the
arithmetic of ``repro/train/optimizer.py``: moments in f32 whatever the
parameter's dtype, bias corrections in f32, the update ``-lr·u`` cast to the
parameter's dtype and added to it.

The reference's optimizers are pure functions of a tree; here an optimizer
holds its parameters and updates them in place. Its state is the reference's
``OptState(step, mu, nu)``: a [] int32 step count (on the CPU) and f32
moments shaped as the parameters, which ``state`` returns.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from repro_torch.utils.tree import global_norm


def cosine_schedule(base_lr: float, warmup: int, total: int, final_frac: float = 0.1):
    """Linear warm-up then cosine decay to ``final_frac·base_lr``, in f32."""
    def lr(step: int) -> float:
        s = torch.tensor(step, dtype=torch.float32)
        warm = base_lr * s / max(1.0, warmup)
        prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = (final_frac * base_lr
               + (1 - final_frac) * base_lr * 0.5 * (1 + torch.cos(math.pi * prog)))
        return float(torch.where(s < warmup, warm, cos))
    return lr


def clip_by_global_norm(grads: list, max_norm: float):
    """(grads scaled so their joint L2 norm is at most ``max_norm``, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], norm


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> list:
    """``p + u`` for every parameter, written into the parameter."""
    for p, u in zip(params, updates):
        p.add_(u)
    return list(params)


class _Optimizer:
    """The parameters, their lr schedule and the step count."""

    def __init__(self, params, lr: float | Callable):
        self.params = list(params)
        self.lr_fn = lr if callable(lr) else (lambda _: lr)
        self._step = torch.zeros((), dtype=torch.int32)

    @property
    def step(self) -> int:
        return int(self._step)


class AdamW(_Optimizer):
    """``update(grads)`` applies one step to ``params`` in place. ``mask``
    holds one bool a parameter (True: decayed); by default a parameter is
    decayed when it has two dimensions or more, the reference's rule on its
    own tree."""

    def __init__(self, params, lr: float | Callable = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 mask: Optional[Sequence[bool]] = None):
        super().__init__(params, lr)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mask = ([p.ndim >= 2 for p in self.params] if mask is None
                     else [bool(m) for m in mask])
        if len(self.mask) != len(self.params):
            raise ValueError(f"mask has {len(self.mask)} entries for {len(self.params)} "
                             f"parameters")
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    def state(self):
        """(step, mu, nu): the live tensors, which ``update`` changes in
        place; copying values into them sets the optimizer's state."""
        return self._step, self.mu, self.nu

    @torch.no_grad()
    def update(self, grads) -> None:
        self._step += 1
        stepf = torch.tensor(float(self.step), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** stepf)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** stepf)
        lr_t = self.lr_fn(self.step)
        for p, g, m, v, decay in zip(self.params, grads, self.mu, self.nu, self.mask):
            g32 = g.float()
            m.mul_(self.b1).add_((1 - self.b1) * g32)
            v.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if decay:
                u = u + self.weight_decay * p.float()
            # one parameter at a time: no second copy of the model
            apply_updates((p,), ((-lr_t * u).to(p.dtype),))


class SGD(_Optimizer):
    """SGD with momentum: an f32 momentum ``mu`` a parameter, the update
    ``-lr·mu``; ``nu`` is empty, as in the reference."""

    def __init__(self, params, lr: float | Callable = 1e-2, momentum: float = 0.0):
        super().__init__(params, lr)
        self.momentum = momentum
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    def state(self):
        return self._step, self.mu, []

    @torch.no_grad()
    def update(self, grads) -> None:
        self._step += 1
        lr_t = self.lr_fn(self.step)
        for p, g, m in zip(self.params, grads, self.mu):
            m.mul_(self.momentum).add_(g.float())
            apply_updates((p,), ((-lr_t * m).to(p.dtype),))
