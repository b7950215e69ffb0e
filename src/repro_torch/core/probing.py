"""The LIRA probing model (paper §3.2); counterpart of ``repro/core/probing.py``.

f(q, I) = p̂ — a multivariate binary classifier over partitions:
    x_q = φ_q(q); x_I = φ_I(I); p̂ = sigmoid(φ_p(x_q ⊕ x_I))        (paper eq. 2)
trained with per-partition BCE against the binary kNN-partition distribution
(paper eq. 3).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.utils.device import resolve_device


class ProbingConfig(NamedTuple):
    dim: int                # query vector dim d
    n_partitions: int       # B
    q_hidden: Sequence[int] = (256, 128)   # φ_q widths
    i_hidden: Sequence[int] = (128,)       # φ_I widths
    p_hidden: Sequence[int] = (256,)       # φ_p widths (before final B-logit layer)


def _mlp(sizes, device) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(a, b, device=device)
                         for a, b in zip(sizes[:-1], sizes[1:]))


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor, *, final_act: bool = True):
    for i, layer in enumerate(layers):
        x = layer(x)
        if final_act or i + 1 < len(layers):
            x = F.relu(x)
    return x


class ProbingModel(nn.Module):
    """φ_q, φ_I and φ_p as ``nn.Linear`` stacks. Weights are He-normal
    (std sqrt(2/fan_in)) from ``generator``, biases zero — the reference's
    init, though not its random numbers. It lives on ``device`` (default: the
    generator's device, else the card, raising when there is none)."""

    def __init__(self, cfg: ProbingConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        if device is None and generator is not None:
            device = generator.device
        device = resolve_device(device)
        self.cfg = cfg
        p_in = cfg.q_hidden[-1] + cfg.i_hidden[-1]
        self.phi_q = _mlp((cfg.dim, *cfg.q_hidden), device)
        self.phi_i = _mlp((cfg.n_partitions, *cfg.i_hidden), device)
        self.phi_p = _mlp((p_in, *cfg.p_hidden, cfg.n_partitions), device)
        with torch.no_grad():
            for layer in self.linears():
                fan_in = layer.in_features
                w = torch.randn(layer.weight.shape, generator=generator,
                                device=layer.weight.device)
                layer.weight.copy_(w * math.sqrt(2.0 / fan_in))
                layer.bias.zero_()

    def linears(self):
        return [*self.phi_q, *self.phi_i, *self.phi_p]

    def forward(self, q: torch.Tensor, cent_dist: torch.Tensor) -> torch.Tensor:
        """Logits over partitions. q: [.., d], cent_dist: [.., B] -> [.., B]."""
        # queries scale-normalized, distances whitened per row
        qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
        i_feat = cent_dist / (cent_dist.mean(-1, keepdim=True) + 1e-6) - 1.0
        x_q = _mlp_apply(self.phi_q, qn)
        x_i = _mlp_apply(self.phi_i, i_feat)
        return _mlp_apply(self.phi_p, torch.cat([x_q, x_i], dim=-1), final_act=False)

    def probs(self, q, cent_dist):
        return torch.sigmoid(self(q, cent_dist))

    def predict_probe_mask(self, q, cent_dist, sigma: float = 0.5):
        """Partitions with p̂ > σ, plus the arg-max partition, which is always
        included (the serve step forces ≥1 probe per query). Returns
        (mask, probs). ``argmax`` takes the first maximum, as JAX's does."""
        p = self.probs(q, cent_dist)
        best = F.one_hot(p.argmax(-1), p.shape[-1]).bool()
        return (p > sigma) | best, p

    def predicted_nprobe(self, q, cent_dist, sigma: float = 0.5) -> torch.Tensor:
        """Probes per query: ``predict_probe_mask``'s mask summed over the
        partitions."""
        mask, _ = self.predict_probe_mask(q, cent_dist, sigma)
        return mask.sum(-1)


def bce_loss(model: ProbingModel, q, cent_dist, labels, *, pos_weight: float = 1.0):
    """Paper eq. 3 (optionally positive-class weighted: labels are sparse)."""
    logits = model(q, cent_dist)
    per = -(pos_weight * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    return per.sum(-1).mean()


def params_from_jax(tree, device=None) -> ProbingModel:
    """A ProbingModel carrying the JAX parameters ``{"phi_q", "phi_i",
    "phi_p": [{"w": [in, out], "b": [out]}, ...]}`` (numpy leaves), on
    ``device`` (default the card, raising when there is none). The widths
    are read off the shapes."""
    def widths(layers):
        return tuple(int(np.shape(layer["w"])[1]) for layer in layers)

    cfg = ProbingConfig(dim=int(np.shape(tree["phi_q"][0]["w"])[0]),
                        n_partitions=int(np.shape(tree["phi_i"][0]["w"])[0]),
                        q_hidden=widths(tree["phi_q"]),
                        i_hidden=widths(tree["phi_i"]),
                        p_hidden=widths(tree["phi_p"])[:-1])
    model = ProbingModel(cfg, device=device)
    with torch.no_grad():
        for name in ("phi_q", "phi_i", "phi_p"):
            for layer, src in zip(getattr(model, name), tree[name]):
                w = torch.tensor(np.asarray(src["w"], np.float32))
                if tuple(w.T.shape) != tuple(layer.weight.shape):
                    raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit "
                                     f"{tuple(layer.weight.shape)}")
                layer.weight.copy_(w.T)
                layer.bias.copy_(torch.tensor(np.asarray(src["b"], np.float32)))
    return model


def params_to_jax(model: ProbingModel) -> dict:
    """The inverse of ``params_from_jax``: ``{"phi_q", "phi_i", "phi_p":
    [{"w": [in, out], "b": [out]}, ...]}`` as f32 numpy arrays, the tree a
    JAX ``LiraEngine`` holds and saves."""
    return {name: [{"w": layer.weight.detach().T.float().cpu().numpy().copy(),
                    "b": layer.bias.detach().float().cpu().numpy().copy()}
                   for layer in getattr(model, name)]
            for name in ("phi_q", "phi_i", "phi_p")}
