"""Mutation planning and slot-plane edits for the epoch-versioned mutable store
(counterpart of ``repro/serving/mutable.py``).

The store is a static-shape [B, capacity] slot grid (per-slot planes declared
by the tier, serving/tiers.py), so a mutation is slot bookkeeping:

  * ``plan_insert``   — greedy nearest-partition-with-a-free-slot placement of
    new rows; says which rows landed off their argmin partition (the
    staleness signal repartition reads) and which found no slot (the grow
    signal). Host numpy over the occupancy plane, as in the reference;
  * ``grow_store``    — widen every per-slot plane to a new capacity, padded
    with ``core.partitions.build_store``'s sentinels;
  * ``compact_store`` — repack live slots to the front of each partition and
    shrink the capacity to the largest live count, erasing tombstones;
  * ``layout_rows``   — a full (partition → slots) layout for a repartition:
    stable within each partition, contiguous slots.

``grow_store``, ``pack_order``, ``compact_store`` and ``layout_rows`` work on
tensors where they lie (the store's planes stay on the card); arrays are
taken as CPU tensors. The invariant the engine keeps on top: a slot is live
iff its occupancy is True; a tombstone is occupancy False with an id ≥ 0 left
behind (healed when the slot is reused or compacted away); the serve step
masks ids with occupancy before the scan.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# how many nearest partitions an inserted row may spill into before the
# engine grows the store instead (further off its argmin partition, probing
# would rarely find it)
PLACE_WINDOW = 4

# pad sentinels per slot plane, as core.partitions.build_store pads (a vector
# of 1e6 never wins a top-k; id -1 is the scan's invalid marker). Other planes
# (codes, cterm, sqnorm) and an integer vector plane zero-fill: ids and
# occupancy mark their slots dead.
_FILL = {"vectors": 1e6, "ids": -1, "occupancy": False}


def fill_value(name: str, dtype: torch.dtype = torch.float32):
    if name == "vectors" and not dtype.is_floating_point:
        return 0
    return _FILL.get(name, 0)


class InsertPlan(NamedTuple):
    parts: np.ndarray        # [n] destination partition (-1 = no slot found)
    slots: np.ndarray        # [n] destination slot within the partition
    misassigned: np.ndarray  # [n] bool: placed, but not in the argmin partition
    ok: np.ndarray           # [n] bool: a slot was found within the window


def plan_insert(occ, dist, *, window: int = PLACE_WINDOW) -> InsertPlan:
    """Place ``n`` new rows into free slots: each row tries its ``window``
    nearest partitions in order (a stable ascending sort of its row of
    ``dist``, taken where ``dist`` lies) and takes the lowest free slot of the
    first one with room. ``occ`` is the [B, capacity] occupancy plane (not
    modified); ``dist`` the [n, B] row→centroid squared distances, an array
    or a tensor. Rows are placed in input order: earlier rows claim contested
    slots first."""
    dist = torch.as_tensor(dist)
    n = dist.shape[0]
    order = torch.sort(dist, dim=1, stable=True).indices[:, :max(1, window)].cpu().numpy()
    occ = occ.cpu().numpy() if isinstance(occ, torch.Tensor) else np.asarray(occ)
    parts = np.full(n, -1, np.int64)
    slots = np.full(n, -1, np.int64)
    # free-slot stacks (lowest slot on top), built for the partitions tried
    free: dict = {}
    for i in range(n):
        for b in order[i]:
            stack = free.get(b)
            if stack is None:
                stack = free[b] = list(np.flatnonzero(~occ[b])[::-1])
            if stack:
                parts[i], slots[i] = b, stack.pop()
                break
    ok = parts >= 0
    return InsertPlan(parts=parts, slots=slots,
                      misassigned=ok & (parts != order[:, 0]), ok=ok)


def grow_store(planes: dict, new_cap: int) -> dict:
    """Widen every per-slot plane (leading dims [B, cap, ...]) to ``new_cap``
    slots, sentinel-padded: new tensors on the planes' devices."""
    out = {}
    for name, arr in planes.items():
        arr = torch.as_tensor(arr)
        if new_cap < arr.shape[1]:
            raise ValueError(f"grow_store cannot shrink {name}: "
                             f"{arr.shape[1]} -> {new_cap} (use compact_store)")
        pad = arr.new_full((arr.shape[0], new_cap - arr.shape[1], *arr.shape[2:]),
                           fill_value(name, arr.dtype))
        out[name] = torch.cat([arr, pad], 1)
    return out


def pack_order(occ):
    """Per-partition permutation that moves live slots to the front (stable:
    live slots keep their order). Returns (perm [B, cap], live [B])."""
    occ = torch.as_tensor(occ)
    perm = torch.sort((~occ).to(torch.uint8), dim=1, stable=True).indices
    return perm, occ.sum(1)


def compact_store(planes: dict, occ, *, min_capacity: int = 1) -> tuple:
    """Repack live slots to the front of each partition and shrink the
    capacity to the largest live count (at least ``min_capacity``):
    tombstones and holes squeezed out, dead tail slots reset to their pad
    sentinels. Returns (planes, new_cap); the planes are new tensors."""
    perm, live = pack_order(occ)
    new_cap = max(int(min_capacity), int(live.max()) if live.numel() else 0)
    rows = torch.arange(perm.shape[0], device=perm.device)[:, None]
    dead = torch.arange(new_cap, device=perm.device)[None, :] >= live[:, None]
    out = {}
    for name, arr in planes.items():
        g = torch.as_tensor(arr)[rows, perm[:, :new_cap]]
        if g.shape[1] < new_cap:        # min_capacity above the old capacity
            g = grow_store({name: g}, new_cap)[name]
        out[name] = g.masked_fill_(dead.reshape(dead.shape + (1,) * (g.ndim - 2)),
                                   fill_value(name, g.dtype))
    return out, new_cap


def layout_rows(assign, n_partitions: int):
    """Contiguous slot layout for a full rebuild: rows of one partition get
    slots 0..count-1 in stable input order. Returns (slots [n], counts [B]),
    int64 tensors where ``assign`` lies."""
    assign = torch.as_tensor(assign).long()
    order = torch.sort(assign, stable=True).indices
    counts = torch.bincount(assign, minlength=n_partitions)
    start = torch.cumsum(counts, 0) - counts
    slots = torch.empty_like(assign)
    slots[order] = torch.arange(len(assign), device=assign.device) - start[assign[order]]
    return slots, counts
