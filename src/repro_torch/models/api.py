"""The uniform model API (counterpart of ``repro/models/api.py``).

Every architecture module exposes ``make_bundle(config, mesh) -> ModelBundle``:

  init(generator)   — real parameters, drawn from ``generator`` (REDUCED
                      configs in the tests; full ones on the card)
  param_specs()     — meta tensors of the parameters (no allocation)
  step(shape)       — a StepDef for a ShapeSpec: the step callable and the
                      specs of its data inputs

Serving steps are ``fn(model, *inputs) -> outputs``. JAX's ShapeDtypeStruct
is a tensor on the ``meta`` device here (shape and dtype, no storage). The
PartitionSpecs of the reference have no counterpart yet: the port's steps run
on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch


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
