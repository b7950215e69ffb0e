"""Device meshes (counterpart of ``repro/launch/mesh.py`` and
``repro.utils.compat.make_mesh``), and the rank-order collectives.

The reference is single-controller: one process drives a ``jax.sharding.Mesh``
of local devices through ``shard_map``. The port keeps that model: a
``Mesh`` is one process's grid of ranks over the axes ``("data", "model")``
(optionally led by ``"pod"``), each rank a ``torch.device``. A device may
carry several ranks, as one JAX CPU device does under
``--xla_force_host_platform_device_count``; on a machine with one card every
rank sits on it, and with several cards the ranks go round-robin over them.
The dry run (``launch/dryrun.py``) puts every rank on the ``meta`` device.

The collectives of the reference's ``shard_map`` regions are carried out in
rank order in one process: ``psum`` adds the ranks' parts, ``all_gather``
concatenates them and ``all_to_all`` swaps the ranks' send buffers. Each
reports the bytes it hands the ranks to the sinks in ``COLLECTIVE_SINKS``
(the op counter of ``launch/op_cost.py`` is one), and to nothing else.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from repro_torch.utils.device import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")

# callables (kind, bytes) told of every collective: the bytes its result
# hands the ranks that receive it, summed over those ranks
COLLECTIVE_SINKS: list = []


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


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production shapes: 16 × 16 over ("data", "model"), or
    2 × 16 × 16 over ("pod", "data", "model"), every rank on ``device``."""
    if multi_pod:
        return make_mesh((2, 16, 16), POD_AXES, device=device)
    return make_mesh((16, 16), AXES, device=device)


# --------------------------------------------------------------- collectives

def _report(kind: str, nbytes: int) -> None:
    for sink in COLLECTIVE_SINKS:
        sink(kind, nbytes)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def psum(parts) -> torch.Tensor:
    """The sum of the ranks' ``parts`` (an iterable, taken in rank order as
    it yields: the first part, then each next one added to the total), every
    part already on the device the sum is wanted on. Each rank receives the
    sum."""
    tot, n = None, 0
    for part in parts:
        tot = part if tot is None else tot + part
        n += 1
    _report("all-reduce", n * _bytes(tot))
    return tot


def all_gather(parts: list, dim: int = 0) -> torch.Tensor:
    """The ranks' ``parts`` concatenated along ``dim`` in rank order, every
    part already on the device the result is wanted on. Each rank receives
    the whole."""
    out = torch.cat(parts, dim)
    _report("all-gather", len(parts) * _bytes(out))
    return out


def all_to_all(bufs: list) -> list:
    """The ranks' send buffers [n, C, ...] (rank j's row k goes to rank k)
    -> the received ones: rank k gets [n, C, ...] with row j from rank j, on
    its own buffer's device."""
    n = len(bufs)
    out = [torch.stack([bufs[j][k].to(bufs[k].device) for j in range(n)]) for k in range(n)]
    _report("all-to-all", sum(_bytes(t) for t in out))
    return out
