"""Device meshes for the serve step (counterpart of ``repro/launch/mesh.py``'s
``make_test_mesh`` and ``repro.utils.compat.make_mesh``).

The reference is single-controller: one process drives a ``jax.sharding.Mesh``
of local devices through ``shard_map``. The port keeps that model: a
``Mesh`` is one process's grid of ranks over the axes ``("data", "model")``
(optionally led by ``"pod"``), each rank a ``torch.device``. A device may
carry several ranks, as one JAX CPU device does under
``--xla_force_host_platform_device_count``; on a machine with one card every
rank sits on it, and with several cards the ranks go round-robin over them.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from repro_torch.utils.device import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks: ``sizes[i]`` ranks along ``axis_names[i]``, and
    ``devices`` the ranks' devices in row-major order over the axes."""

    axis_names: tuple
    sizes: tuple
    devices: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(s < 1 for s in self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.sizes} do not match")
        n = math.prod(self.sizes)
        if len(self.devices) != n:
            raise ValueError(f"{len(self.devices)} devices for {n} ranks")

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def unique_devices(self) -> tuple:
        """The distinct devices, in rank order."""
        return tuple(dict.fromkeys(self.devices))


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the ``cuda:<i>`` its tensors report, so a rank's device
    compares equal to the device of the tensors placed on it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape, axis_names, *, device=None, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axis_names``. Ranks go round-robin over
    ``devices`` when a list is given, else every rank is on ``device``
    (default the card: raises when there is none)."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if devices is not None and device is not None:
        raise TypeError("pass device= or devices=, not both")
    n = math.prod(shape)
    pool = [_indexed(resolve_device(d))
            for d in (devices if devices is not None else [device])]
    if not pool:
        raise ValueError("devices= is empty")
    return Mesh(axis_names, shape, tuple(itertools.islice(itertools.cycle(pool), n)))


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0, *, device=None,
                   devices=None) -> Mesh:
    """The reference's small mesh (same axis names as its production mesh):
    ``(data, model)``, led by ``pod`` when it is nonzero."""
    if pod:
        return make_mesh((pod, data, model), POD_AXES, device=device, devices=devices)
    return make_mesh((data, model), AXES, device=device, devices=devices)
