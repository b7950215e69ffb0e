"""Logical-axis sharding rules, resolved to mesh axes (counterpart of
``repro/distributed/sharding.py``).

The mesh axes are ("pod", "data", "model") (``launch.mesh``); a single-pod
mesh lacks "pod". Logical names annotate every parameter and activation
dimension and the rules below map them to mesh axes:

  * activations: batch -> ("pod", "data"), sequence -> "model";
  * parameters: "fsdp" -> "data", the wide dims ("mlp", "heads_flat",
    "expert", "vocab", "rows") -> "model".

A partition spec is JAX's ``PartitionSpec`` as a plain tuple: one entry a
dimension, ``None``, an axis name or a tuple of names. The port computes the
reference's layout-only regions (its sharding constraints) on whole tensors;
what a rank stores and computes follows these specs only where the
reference's ``shard_map`` regions split a tensor (``models.api.model_splits``).
"""
from __future__ import annotations

from typing import Optional, Sequence

LOGICAL_RULES: dict = {
    # activations
    "batch": ("pod", "data"),
    "seq": "model",
    "flat_batch": ("pod", "data", "model"),  # fully flattened (GNN edges, bulk scoring)
    # params
    "fsdp": "data",
    "mlp": "model",
    "heads_flat": "model",     # flattened H*Dh projection output dim
    "expert": "model",
    "vocab": "model",
    "rows": "model",           # embedding-table rows
    "stack": None,             # the layer axis: never sharded
    "embed": None,
    "kv": None,
    "head_dim": None,
    "none": None,
}


def logical_to_pspec(axes: Sequence[Optional[str]], mesh) -> tuple:
    """Map logical axis names to a partition spec valid on ``mesh``: axes
    missing from the mesh are dropped, ``None`` stays unsharded."""
    mesh_axes = set(mesh.axis_names)
    out = []
    for ax in axes:
        rule = None if ax is None else LOGICAL_RULES.get(ax)
        if rule is None:
            out.append(None)
        elif isinstance(rule, tuple):
            present = tuple(r for r in rule if r in mesh_axes)
            out.append(present if len(present) > 1 else (present[0] if present else None))
        else:
            out.append(rule if rule in mesh_axes else None)
    return tuple(out)


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def seq_axis(mesh):
    return "model" if "model" in mesh.axis_names else None


def axes_entry(axes: tuple):
    """A spec entry for ``axes``: None, the one name, or the tuple."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def axes_size(mesh, axes) -> int:
    """The number of ranks along ``axes`` together."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
