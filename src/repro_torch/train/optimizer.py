"""AdamW, cosine schedule and global-norm clipping with the arithmetic of
``repro/train/optimizer.py`` (f32 moments, bias corrections in f32, update
``-lr·m̂/(sqrt(v̂)+eps)``, decay on tensors with ndim ≥ 2)."""
from __future__ import annotations

import math
from typing import Callable

import torch


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
    norm = torch.sqrt(torch.stack([(g.float() ** 2).sum() for g in grads]).sum())
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], norm


class AdamW:
    """``update(grads)`` applies one step to ``params`` in place. Its state
    is JAX's ``OptState(step, mu, nu)``: a [] int32 step count (on the CPU)
    and f32 moments shaped as the parameters, which ``state`` returns."""

    def __init__(self, params, lr: float | Callable = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        self.params = list(params)
        self.lr_fn = lr if callable(lr) else (lambda _: lr)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self._step = torch.zeros((), dtype=torch.int32)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @property
    def step(self) -> int:
        return int(self._step)

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
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g32 = g.float()
            m.mul_(self.b1).add_((1 - self.b1) * g32)
            v.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if p.ndim >= 2 and self.weight_decay:
                u = u + self.weight_decay * p.float()
            p.add_((-lr_t * u).to(p.dtype))
