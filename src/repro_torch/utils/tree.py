"""Small helpers over trees of tensors (counterpart of ``repro/utils/tree.py``).

A tree is a tensor, or a dict, list or tuple of trees; its leaves come in
JAX's flatten order (dict keys sorted, sequences in order, None empty).
"""
from __future__ import annotations

import math

import torch


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, node) for node in tree)
    return fn(tree)


def tree_count(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)))


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors (meta tensors too)."""
    return int(sum(math.prod(x.shape) * x.element_size() for x in tree_leaves(tree)))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves, each leaf's sum of squares taken in f32."""
    sums = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())
