"""Serving-tier registry (counterpart of ``repro/serving/tiers.py``); only
the exact f32 tier is ported so far. A tier declares its store fields and
builds them from the host-side partition store."""
from __future__ import annotations

import torch

# fields every tier provides — the serve step's probing/dispatch/scan operands
BASE_FIELDS = ("centroids", "vectors", "ids", "occupancy")

STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def store_dtype(cfg) -> torch.dtype:
    try:
        return STORE_DTYPES[cfg.store_dtype]
    except KeyError:
        raise ValueError(f"store_dtype {cfg.store_dtype!r} not in {sorted(STORE_DTYPES)}") from None


class F32Tier:
    """The exact f32 scan. ``cfg.store_dtype`` sets the vector plane's dtype
    (bfloat16 halves scan reads; distances accumulate in f32 either way)."""

    name = "f32"
    aliases = ("exact", "float32")

    def store_specs(self, cfg) -> dict:
        """Field name → (shape, dtype)."""
        b, c, d = cfg.n_partitions, cfg.capacity, cfg.dim
        return {"centroids": ((b, d), torch.float32),
                "vectors": ((b, c, d), store_dtype(cfg)),
                "ids": ((b, c), torch.int32),
                "occupancy": ((b, c), torch.bool)}

    def build_store(self, cfg, store_h) -> dict:
        ids = store_h.ids
        return {"centroids": store_h.centroids,
                "vectors": store_h.vectors.to(store_dtype(cfg)),
                "ids": ids, "occupancy": ids >= 0}


_REGISTRY = {name: F32Tier() for name in (F32Tier.name, *F32Tier.aliases)}


def resolve(tier):
    """Tier name (or instance) → the registered tier. The quantized tiers
    (pq, residual_pq) are not ported yet and raise like a typo does."""
    if isinstance(tier, F32Tier):
        return tier
    try:
        return _REGISTRY[tier]
    except KeyError:
        raise ValueError(f"unknown or unported serving tier {tier!r}; "
                         f"available: {sorted(_REGISTRY)}") from None
