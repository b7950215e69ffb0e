"""The uniform model API (counterpart of ``repro/models/api.py``).

Every architecture module exposes ``make_bundle(config, mesh) -> ModelBundle``:

  init(generator)   — real parameters, drawn from ``generator`` (REDUCED
                      configs in the tests; full ones on the card)
  param_specs()     — meta tensors of the parameters (no allocation)
  param_pspecs()    — the reference's partition specs of the parameters
  step(shape)       — a StepDef for a ShapeSpec: the step callable and the
                      specs of its data inputs
  opt_specs()       — the AdamW state as meta tensors (train kinds; the dry
                      run reads it), ``opt_pspecs()`` its partition specs

Serving steps are ``fn(model, *inputs) -> outputs``; train steps are
``fn(state, batch) -> (state, metrics)`` with ``state`` a ``TrainState``.
JAX's ShapeDtypeStruct is a tensor on the ``meta`` device here (shape and
dtype, no storage); its PartitionSpec is a tuple (``distributed.sharding``),
and each model module's ``param_pspecs(cfg, mesh)`` gives the reference's.

A model's parameters are the reference's tree: ``named_leaves()`` yields
(dotted path, the reference leaf's shape, the tensors that hold it), one
tensor a leaf, one a layer for a leaf the reference stacks [L, ...] and the
port holds a layer at a time (the LM), and for a leaf that a ``shard_map``
region of the reference reads in slices, one a "model" rank (layer-major):
``split_of(path)`` gives ``(dim, n)``, the leaf's dimension cut into ``n``
equal slices, rank ``j``'s slice stored on the device of the mesh's rank
``j`` (the first with that model index). Other leaves are stored on the
mesh's first device, and a rank on another device reads its copy there
(``replica``: made once a device, kept until the leaf changes, its gradient
sent back to the leaf). ``join`` / ``fill`` turn a leaf's
tensors into the reference's whole leaf and back, whatever the mesh:
``from_jax_tree`` / ``to_jax_tree``, ``adamw`` and ``TrainState`` (whose
checkpoint holds whole leaves in ``jax.tree.flatten`` order) go through them.
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
    param_pspecs: Optional[Callable] = None   # () -> {name: partition spec tuple}
    # () -> the AdamW state's specs {"step", "mu", "nu"} and partition specs
    opt_specs: Optional[Callable] = None
    opt_pspecs: Optional[Callable] = None


def sds(shape, dtype=torch.float32) -> torch.Tensor:
    """A shape and dtype without storage: a tensor on the meta device."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def adamw_state_specs(param_specs_tree: dict) -> dict:
    """The AdamW state of ``param_specs_tree`` as meta tensors, in the
    reference's ``OptState(step, mu, nu)`` layout: a [] int32 step and f32
    moments shaped as the parameters."""
    def f32(s):
        return sds(s.shape)

    return {"step": sds((), torch.int32), "mu": _tree_map(f32, param_specs_tree),
            "nu": _tree_map(f32, param_specs_tree)}


def adamw_state_pspecs(param_pspecs_tree: dict) -> dict:
    """Partition specs of ``adamw_state_specs``: the step replicated, each
    moment as its parameter."""
    def same(p):
        return p

    return {"step": (), "mu": _tree_map(same, param_pspecs_tree),
            "nu": _tree_map(same, param_pspecs_tree)}


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


def on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: itself when it is there, else a (differentiable)
    copy."""
    return t if t.device == dev else t.to(dev)


class _Replicas(dict):
    """(id of a parameter, device) -> (its version, data pointer, copy); a
    deep copy of the owner starts empty, as its parameters are new."""

    def __deepcopy__(self, memo):
        return _Replicas()


class _Replica(torch.autograd.Function):
    """A parameter's stored copy on another device: the forward reads the
    copy, the backward sends the copy's gradient to the parameter's device."""

    @staticmethod
    def forward(ctx, master, copy):
        ctx.dev = master.device
        return copy.view_as(copy)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dev), None


def replica(owner, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t``, a parameter of ``owner`` (a module), on ``dev``: itself when it
    is there, else its copy there, made once a device and remade only after
    ``t`` has changed in place (an optimizer step, a load). While autograd
    records, the copy's gradient is added to ``t``'s. The dense weights of a
    meshed model are read so: stored once a device, as the reference keeps
    a replicated leaf on every device."""
    if t.device == dev:
        return t
    cache = owner.__dict__.setdefault("_replicas", _Replicas())
    key = (id(t), dev)
    hit = cache.get(key)
    if hit is None or hit[:2] != (t._version, t.data_ptr()):
        with torch.inference_mode(False), torch.no_grad():
            hit = cache[key] = (t._version, t.data_ptr(), t.detach().to(dev, copy=True))
    if torch.is_grad_enabled() and t.requires_grad:
        return _Replica.apply(t, hit[2])
    return hit[2]


def model_splits(pspecs: dict, paths, shapes: dict, mesh) -> dict:
    """path -> the dimension of each leaf in ``paths`` that its partition
    spec (``pspecs``, flat by path) shards over "model", for a mesh with
    more than one model rank; a leaf whose spec names no "model" is left
    whole. A dimension that does not split evenly raises."""
    n = mesh.shape.get("model", 1)
    out = {}
    if n == 1:
        return out
    for path in paths:
        dims = [i for i, e in enumerate(pspecs[path])
                if e == "model" or (isinstance(e, tuple) and "model" in e)]
        if not dims:
            continue
        size = shapes[path][dims[0]]
        if size % n:
            raise ValueError(f"{path}: dimension {dims[0]} of {tuple(shapes[path])} ({size}) "
                             f"does not split over {n} model ranks")
        out[path] = dims[0]
    return out


def sliced(shape, dim: int, n: int) -> tuple:
    """``shape`` with dimension ``dim`` divided by ``n``."""
    return tuple(s // n if i == dim else s for i, s in enumerate(shape))


def _layout(model, path: str, shape, tensors):
    """(split dim in a piece's coordinates or None, slices a layer, stacked)."""
    split = model.split_of(path)
    stacked = tensors[0].ndim < len(shape)
    if split is None:
        return None, 1, stacked
    return split[0] - stacked, split[1], stacked


def join(model, path: str, shape, tensors) -> torch.Tensor:
    """The reference's whole leaf ``path`` from ``tensors`` (the leaf's
    tensors, or tensors laid out as them: its AdamW moments), a detached copy
    on the first tensor's device: each layer's slices concatenated in rank
    order, the layers stacked."""
    dim, n, stacked = _layout(model, path, shape, tensors)
    dev = tensors[0].device
    pieces = [t.detach() for t in tensors]
    layers = [pieces[i] if n == 1 else torch.cat([on(t, dev) for t in pieces[i:i + n]], dim)
              for i in range(0, len(pieces), n)]
    return torch.stack([on(t, dev) for t in layers]) if stacked else layers[0].clone()


@torch.no_grad()
def fill(model, path: str, shape, tensors, src: torch.Tensor) -> None:
    """Copies the whole leaf ``src`` (the reference's shape) into
    ``tensors``, each its layer's and rank's slice."""
    if tuple(src.shape) != tuple(shape):
        raise ValueError(f"{path}: {tuple(src.shape)} does not fit {tuple(shape)}")
    dim, n, stacked = _layout(model, path, shape, tensors)
    wholes = list(src) if stacked else [src]
    for li, whole in enumerate(wholes):
        for j, part in enumerate(whole.chunk(n, dim) if n > 1 else [whole]):
            tensors[li * n + j].copy_(part)


class TreeModel(nn.Module):
    """Parameters laid out as the reference's tree: one uninitialised f32
    tensor a leaf of ``defs`` (dotted path -> shape, the reference's order),
    on ``device`` (default the card) or, given a ``mesh``, on its first
    device, and the leaves in ``splits`` (path -> dim, ``model_splits``) cut
    into one slice a model rank, each on its rank's device. ``model[path]``
    is a whole leaf, ``shards(path)`` a split one's slices in rank order."""

    def __init__(self, cfg, defs: dict, device=None, *, mesh=None, splits=None):
        super().__init__()
        self.cfg = cfg
        self.defs = dict(defs)
        self.mesh = mesh
        self.splits = dict(splits or {})
        dev = resolve_device(mesh.devices[0] if mesh is not None else device)
        self.leaves = nn.ParameterDict()
        for path, shape in self.defs.items():
            if path in self.splits:
                n = mesh.shape["model"]
                for j in range(n):
                    self.leaves[f"{path.replace('.', '/')}:{j}"] = nn.Parameter(torch.empty(
                        sliced(shape, self.splits[path], n), dtype=torch.float32,
                        device=mesh.devices[j]))
            else:
                self.leaves[path.replace(".", "/")] = nn.Parameter(
                    torch.empty(shape, dtype=torch.float32, device=dev))

    def __getitem__(self, path: str) -> nn.Parameter:
        if path in self.splits:
            raise KeyError(f"{path} is held in slices: model.shards({path!r})")
        return self.leaves[path.replace(".", "/")]

    def split_of(self, path: str):
        """(dim, model ranks) for a leaf held in slices, else None."""
        return (self.splits[path], self.mesh.shape["model"]) if path in self.splits else None

    def shards(self, path: str) -> list:
        """The leaf's tensors: its slices in model-rank order, or the whole
        leaf alone."""
        if path not in self.splits:
            return [self[path]]
        key = path.replace(".", "/")
        return [self.leaves[f"{key}:{j}"] for j in range(self.mesh.shape["model"])]

    @property
    def device(self) -> torch.device:
        return next(iter(self.leaves.values())).device

    def named_leaves(self):
        for path, shape in self.defs.items():
            yield path, shape, self.shards(path)


@torch.no_grad()
def from_jax_tree(model, params_np: dict):
    """Copies the JAX tree ``params_np`` (nested dict of arrays, whole
    leaves) into ``model``'s leaves, each slice to its rank; a leaf of
    another shape raises."""
    for path, shape, tensors in model.named_leaves():
        node = params_np
        for part in path.split("."):
            node = node[part]
        if tuple(np.shape(node)) != tuple(shape):
            raise ValueError(f"{path}: shape {np.shape(node)} does not fit {shape}")
        fill(model, path, shape, tensors, torch.from_numpy(np.array(node, dtype=np.float32)))
    return model


def to_jax_tree(model) -> dict:
    """The inverse of ``from_jax_tree``: the nested tree of whole leaves as
    numpy arrays (f32; bfloat16 upcast exactly, as npy has no bf16)."""
    return nest({path: join(model, path, shape, tensors).float().cpu().numpy()
                 for path, shape, tensors in model.named_leaves()})


@torch.no_grad()
def copy_leaves(dst, src) -> None:
    """Copies every whole leaf of ``src`` into ``dst`` (the same tree, on
    any mesh): e.g. an unsharded model's weights onto a meshed one."""
    srcs = {path: (shape, tensors) for path, shape, tensors in src.named_leaves()}
    for path, shape, tensors in dst.named_leaves():
        sshape, stensors = srcs[path]
        whole = join(src, path, sshape, stensors)
        fill(dst, path, shape, tensors, on(whole, tensors[0].device))


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
        """(name, path, shape, tensors) of every leaf, in flatten order; the
        step's path and shape are None."""
        step, mu, nu = self.tx.state()
        at = {id(p): i for i, p in enumerate(self.tx.params)}
        order = jax_order(self.model)
        slots = [(f"params/{path}", path, shape, tensors) for path, shape, tensors in order]
        slots.append(("opt/step", None, None, [step]))
        for name, moment in (("mu", mu), ("nu", nu)):
            slots += [(f"opt/{name}/{path}", path, shape, [moment[at[id(t)]] for t in tensors])
                      for path, shape, tensors in order]
        return slots

    def leaf_names(self) -> list:
        return [slot[0] for slot in self._slots()]

    def leaves(self) -> list:
        """Whole leaves (a split leaf's slices joined, a layered leaf
        stacked), as copies on the leaf's first device."""
        return [tensors[0].detach().clone() if path is None
                else join(self.model, path, shape, tensors)
                for _, path, shape, tensors in self._slots()]

    @torch.no_grad()
    def load_leaves(self, leaves) -> None:
        slots = self._slots()
        if len(leaves) != len(slots):
            raise ValueError(f"{len(leaves)} leaves for a state of {len(slots)}")
        for (name, path, shape, tensors), src in zip(slots, leaves):
            if path is None:
                if tuple(tensors[0].shape) != tuple(src.shape):
                    raise ValueError(f"{name}: {tuple(src.shape)} does not fit "
                                     f"{tuple(tensors[0].shape)}")
                tensors[0].copy_(src)
                continue
            try:
                fill(self.model, path, shape, tensors, src)
            except ValueError as e:
                raise ValueError(f"{name}: {e}") from None
