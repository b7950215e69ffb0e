"""The uniform model API (counterpart of ``repro/models/api.py``).

Every architecture module exposes ``make_bundle(config, mesh) -> ModelBundle``:

  init(generator)   — real parameters, drawn from ``generator`` (REDUCED
                      configs in the tests; full ones on the card)
  param_specs()     — meta tensors of the parameters (no allocation)
  step(shape)       — a StepDef for a ShapeSpec: the step callable and the
                      specs of its data inputs

Serving steps are ``fn(model, *inputs) -> outputs``; train steps are
``fn(state, batch) -> (state, metrics)`` with ``state`` a ``TrainState``.
JAX's ShapeDtypeStruct is a tensor on the ``meta`` device here (shape and
dtype, no storage). The PartitionSpecs of the reference have no counterpart
yet: the port's steps run on one device.

A model's parameters are the reference's tree: ``named_leaves()`` yields
(dotted path, the reference leaf's shape, the tensors that hold it), one
tensor a leaf, or one a layer for a leaf the reference stacks [L, ...] and
the port holds a layer at a time (the LM). ``TreeModel`` holds one tensor a
leaf, by path; ``from_jax_tree`` / ``to_jax_tree`` carry a JAX tree of it by
copying; ``adamw`` and ``TrainState`` follow ``jax.tree.flatten``'s order of
any such model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.train import optimizer as opt
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment."""

    name: str                     # e.g. "train_4k"
    kind: str                     # train | prefill | decode | lira_serve | lira_train | ...
    dims: Mapping[str, int]       # shape parameters (seq_len, global_batch, ...)

    def __getitem__(self, k):
        return self.dims[k]


@dataclasses.dataclass
class StepDef:
    """A step: its callable and its data inputs' specs (name → meta tensor,
    or a dict of them)."""

    fn: Callable
    input_specs: dict


@dataclasses.dataclass
class ModelBundle:
    name: str
    config: Any
    init: Callable               # generator -> model (an nn.Module)
    param_specs: Callable        # () -> {name: meta tensor}
    step: Callable               # ShapeSpec -> StepDef
    # model -> the optimizer its train steps update (train kinds only)
    optimizer: Optional[Callable] = None


def sds(shape, dtype=torch.float32) -> torch.Tensor:
    """A shape and dtype without storage: a tensor on the meta device."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def nest(flat: dict) -> dict:
    """{"a.b": x} -> {"a": {"b": x}}: the reference's nested tree."""
    out: dict = {}
    for path, val in flat.items():
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


class TreeModel(nn.Module):
    """Parameters laid out as the reference's tree: one uninitialised f32
    tensor a leaf of ``defs`` (dotted path -> shape, the reference's order),
    on ``device`` (default the card). ``model[path]`` is the leaf."""

    def __init__(self, cfg, defs: dict, device=None):
        super().__init__()
        self.cfg = cfg
        self.defs = dict(defs)
        dev = resolve_device(device)
        self.leaves = nn.ParameterDict({
            path.replace(".", "/"): nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                                             device=dev))
            for path, shape in self.defs.items()})

    def __getitem__(self, path: str) -> nn.Parameter:
        return self.leaves[path.replace(".", "/")]

    @property
    def device(self) -> torch.device:
        return next(iter(self.leaves.values())).device

    def named_leaves(self):
        for path, shape in self.defs.items():
            yield path, shape, [self[path]]


@torch.no_grad()
def from_jax_tree(model: TreeModel, params_np: dict) -> TreeModel:
    """Copies the JAX tree ``params_np`` (nested dict of arrays) into
    ``model``'s leaves; a leaf of another shape raises."""
    for path, shape, (t,) in model.named_leaves():
        node = params_np
        for part in path.split("."):
            node = node[part]
        if tuple(np.shape(node)) != tuple(shape):
            raise ValueError(f"{path}: shape {np.shape(node)} does not fit {shape}")
        t.copy_(torch.from_numpy(np.array(node, dtype=np.float32)))
    return model


def to_jax_tree(model: TreeModel) -> dict:
    """The inverse of ``from_jax_tree``: the nested tree of numpy arrays."""
    return nest({path: t.detach().cpu().numpy() for path, _, (t,) in model.named_leaves()})


def jax_order(model) -> list:
    """(path, shape of the reference's leaf, tensors) of every leaf, in
    ``jax.tree.flatten`` order of the reference's tree (dict keys sorted)."""
    return sorted(model.named_leaves(), key=lambda leaf: leaf[0].split("."))


def adamw(model, lr, **kw) -> opt.AdamW:
    """The reference's ``adamw(lr, **kw)`` over ``model``: AdamW over its
    parameters, each decayed when the reference's leaf that holds it has two
    dimensions or more (the LM stacks its layers there, so a layer's [D]
    norm is decayed as a leaf of [L, D])."""
    params, mask = [], []
    for _, shape, tensors in jax_order(model):
        params += tensors
        mask += [len(shape) >= 2] * len(tensors)
    return opt.AdamW(params, lr, mask=mask, **kw)


class TrainState(NamedTuple):
    """A model and its AdamW as the ``Trainer`` checkpoints them.
    ``leaves()`` lists the reference's ``(params, OptState(step, mu, nu))``
    in ``jax.tree.flatten`` order (``leaf_names``), as copies, a leaf the
    port holds a layer at a time stacked [L, ...] as the reference holds it;
    ``load_leaves`` copies such a list back into the model and the
    optimizer. Unpacks as ``model, tx = state``."""

    model: nn.Module
    tx: opt.AdamW

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _slots(self) -> list:
        """(name, tensors, stacked) of every leaf, in flatten order."""
        step, mu, nu = self.tx.state()
        at = {id(p): i for i, p in enumerate(self.tx.params)}
        order = jax_order(self.model)
        stacked = {path: len(shape) > tensors[0].ndim for path, shape, tensors in order}
        slots = [(f"params/{path}", tensors, stacked[path]) for path, _, tensors in order]
        slots.append(("opt/step", [step], False))
        for name, moment in (("mu", mu), ("nu", nu)):
            slots += [(f"opt/{name}/{path}", [moment[at[id(t)]] for t in tensors], stacked[path])
                      for path, _, tensors in order]
        return slots

    def leaf_names(self) -> list:
        return [name for name, _, _ in self._slots()]

    def leaves(self) -> list:
        return [torch.stack([t.detach() for t in tensors]) if stacked
                else tensors[0].detach().clone() for _, tensors, stacked in self._slots()]

    @torch.no_grad()
    def load_leaves(self, leaves) -> None:
        slots = self._slots()
        if len(leaves) != len(slots):
            raise ValueError(f"{len(leaves)} leaves for a state of {len(slots)}")
        for (name, tensors, stacked), src in zip(slots, leaves):
            for t, s in zip(tensors, src if stacked else [src]):
                if tuple(t.shape) != tuple(s.shape):
                    raise ValueError(f"{name}: {tuple(s.shape)} does not fit {tuple(t.shape)}")
                t.copy_(s)


def check_one_device(mesh, what: str) -> None:
    """Raises unless ``mesh`` is 1 × 1: ``what`` names the meshed path that
    is not ported yet."""
    if any(s != 1 for s in mesh.sizes):
        raise NotImplementedError(f"this model runs on one device; mesh {mesh.shape} needs "
                                  f"{what}, which is not ported yet")
