"""Probing-model training loop (paper §3.2 + appendix A.5); counterpart of
``repro/core/train_probing.py:train_probing_model``.

The batch order follows the reference exactly (``np.random.default_rng(0)``
permutations, with the evaluation subsample drawn from the same stream), so
from the same initial parameters both sides see the same batches.

``train_state`` and ``make_train_step`` give the model and its AdamW to
``train.trainer.Trainer`` as the reference's examples give theirs: the state
in ``jax.tree.flatten((params, OptState(step, mu, nu)))`` order and layout,
so a checkpoint either package writes resumes in the other.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import probing
from repro_torch.core.kmeans import centroid_distances
from repro_torch.train import optimizer as opt
from repro_torch.utils.device import input_device


class TrainLog(NamedTuple):
    losses: list
    recalls: list        # probe-mask recall of kNN partitions (paper Fig 11)
    nprobes: list        # mean predicted nprobe
    hit_rates: list      # fraction of probed partitions that are kNN partitions
    seconds: float


@torch.no_grad()
def _probe_quality(model, q, cd, labels, sigma=0.5):
    mask, _ = model.predict_probe_mask(q, cd, sigma)
    maskf = mask.float()
    tp = (maskf * labels).sum(-1)
    covered = tp / labels.sum(-1).clamp_min(1.0)      # recall of kNN partitions
    hit = tp / maskf.sum(-1).clamp_min(1.0)           # precision of probes
    return covered.mean(), hit.mean(), maskf.sum(-1).mean()


def train_probing_model(x_train, labels, centroids, *, epochs: int = 10,
                        batch: int = 512, lr: float = 1e-3, pos_weight: float = 1.0,
                        eval_every: int = 10, cfg: probing.ProbingConfig | None = None,
                        log: bool = False, model: probing.ProbingModel | None = None,
                        generator: torch.Generator | None = None, device=None):
    """Returns (model, TrainLog). labels: binary kNN-partition masks [N_sub, B].

    ``model`` is trained in place when given (tests pass the reference's
    initial parameters through ``probing.params_from_jax``); otherwise a new
    one is drawn from ``generator``. Everything runs on ``device`` (default:
    the device of x_train when it is a tensor, else of ``model``, else the
    card, raising when there is none)."""
    device = input_device(device, x_train, *(model.parameters() if model is not None else ()))
    x = torch.as_tensor(x_train, dtype=torch.float32, device=device)
    lab = torch.as_tensor(labels, dtype=torch.float32, device=device)
    cents = torch.as_tensor(centroids, dtype=torch.float32, device=device)
    n, d = x.shape
    if model is None:
        cfg = cfg or probing.ProbingConfig(dim=d, n_partitions=cents.shape[0])
        model = probing.ProbingModel(cfg, generator=generator, device=device)
    params = list(model.parameters())
    steps_per_epoch = max(1, n // batch)
    tx = opt.AdamW(params, opt.cosine_schedule(lr, warmup=50, total=epochs * steps_per_epoch))

    with torch.no_grad():
        cd_all = centroid_distances(x, cents)
    tlog = TrainLog([], [], [], [], 0.0)
    t0 = time.time()
    host_rng = np.random.default_rng(0)
    it = 0
    for ep in range(epochs):
        perm = host_rng.permutation(n)
        for s in range(0, steps_per_epoch * batch, batch):
            sel = torch.as_tensor(perm[s:s + batch], device=device)
            loss = probing.bce_loss(model, x[sel], cd_all[sel], lab[sel],
                                    pos_weight=pos_weight)
            grads = torch.autograd.grad(loss, params)
            grads, _ = opt.clip_by_global_norm(grads, 1.0)
            tx.update(grads)
            if it % eval_every == 0:
                sub = torch.as_tensor(host_rng.choice(n, size=min(2048, n), replace=False),
                                      device=device)
                cov, hit, npb = _probe_quality(model, x[sub], cd_all[sub], lab[sub])
                tlog.losses.append(float(loss.detach()))
                tlog.recalls.append(float(cov))
                tlog.hit_rates.append(float(hit))
                tlog.nprobes.append(float(npb))
                if log:
                    print(f"ep{ep} it{it} loss={tlog.losses[-1]:.3f} part-recall={float(cov):.3f} "
                          f"hit={float(hit):.3f} nprobe={float(npb):.2f}")
            it += 1
    return model, tlog._replace(seconds=time.time() - t0)


_GROUPS = ("phi_i", "phi_p", "phi_q")   # the params dict's keys, sorted as JAX flattens


def _jax_order(model: probing.ProbingModel) -> list:
    """(name, tensor) of every parameter in JAX's flatten order of the
    params dict (groups sorted; in each layer "b" before "w")."""
    return [(f"{g}/{i}/{leaf}", layer.bias if leaf == "b" else layer.weight)
            for g in _GROUPS for i, layer in enumerate(getattr(model, g))
            for leaf in ("b", "w")]


def state_leaf_names(model: probing.ProbingModel) -> list:
    """Leaf names of ``train_state``, in order: the params, "opt/step",
    then the params' "opt/mu/…" and "opt/nu/…"."""
    names = [n for n, _ in _jax_order(model)]
    return ([f"params/{n}" for n in names] + ["opt/step"]
            + [f"opt/mu/{n}" for n in names] + [f"opt/nu/{n}" for n in names])


def train_state(model: probing.ProbingModel, tx: opt.AdamW) -> list:
    """The live state of ``model`` and its optimizer ``tx`` as a flat list in
    ``state_leaf_names`` order: each weight as the reference's ``w`` [in, out]
    (a transposed view), each bias as ``b``, the step count, then the
    moments in the same layout. Writing into a leaf writes into the model
    or the optimizer."""
    step, mu, nu = tx.state()
    at = {id(p): i for i, p in enumerate(tx.params)}

    def jax_layout(t, p):
        return t.T if p.ndim == 2 else t

    params = [p for _, p in _jax_order(model)]
    return ([jax_layout(p, p) for p in params] + [step]
            + [jax_layout(mu[at[id(p)]], p) for p in params]
            + [jax_layout(nu[at[id(p)]], p) for p in params])


def make_train_step(model: probing.ProbingModel, tx: opt.AdamW):
    """The reference example's step as a ``Trainer`` step function: BCE loss,
    gradients clipped to global norm 1, one AdamW update, all in place on
    ``model`` and ``tx`` (the state it is handed is their ``train_state``,
    returned as it is). Metrics: loss and grad_norm."""
    params = list(tx.params)

    def step_fn(state, batch):
        loss = probing.bce_loss(model, batch["q"], batch["cent_dist"], batch["labels"])
        grads, gnorm = opt.clip_by_global_norm(torch.autograd.grad(loss, params), 1.0)
        tx.update(grads)
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step_fn
