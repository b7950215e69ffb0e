"""Serving-tier registry (counterpart of ``repro/serving/tiers.py``). A tier
declares its store fields, builds them from the partition store, says which
stores it can serve, and hands the scan its extra operands:

  * ``store_specs(cfg)`` — every store field's shape and dtype;
  * ``store_pspecs(cfg)`` — for each field, the mesh axis its first dimension
    is split over (``"model"``: one block of partitions a rank) or ``None``
    (every rank holds all of it);
  * ``build_store(cfg, store_h, generator=)`` — (store dict, cfg), cfg amended
    where the build resolves a knob (PQ's ``pq_m`` default, ``pq_ks`` clamp);
  * ``encode_rows(cfg, store, x, parts)`` — the per-slot content planes of
    new rows bound for partitions ``parts`` (insert, repartition);
  * ``check_servable(cfg)`` — raise if the tier cannot serve a store built
    for ``cfg.tier`` (beyond field presence, which the engine checks);
  * ``scan_kwargs(cfg, ctx, fields)`` — extra ``scan.run`` operands; ``{}``
    is the plain f32 scan.

Registered: ``f32`` (exact scan; ``cfg.store_dtype`` sets the vector plane's
dtype), ``pq`` (shared-LUT ADC shortlist + exact rerank) and ``residual_pq``
(codes over x − centroid, with the residual offsets). Adding a tier is one
class decorated with ``register``, here or anywhere else: the engine, the
scan, ``save`` / ``load`` and the serve cache resolve tiers by name and
never branch on one.
"""
from __future__ import annotations

import dataclasses

import torch

# fields every tier provides — the serve step's probing/dispatch/rerank
# operands; tiers add their scan-stage fields after these
BASE_FIELDS = ("centroids", "vectors", "ids", "occupancy")

STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_REGISTRY: dict[str, "Tier"] = {}


def register(cls):
    """Class decorator: instantiate the tier and index it under its name and
    aliases. A later registration of a name wins, so a test can shadow a
    tier and restore it."""
    tier = cls()
    for name in (cls.name, *cls.aliases):
        _REGISTRY[name] = tier
    return cls


def resolve(tier) -> "Tier":
    """Tier name, alias or instance → the registered tier; a typo raises."""
    if isinstance(tier, Tier):
        return tier
    try:
        return _REGISTRY[tier]
    except KeyError:
        raise ValueError(f"unknown serving tier {tier!r}; registered tiers: "
                         f"{names()}") from None


def names() -> tuple:
    """The registered tiers' canonical names, sorted (aliases collapsed)."""
    return tuple(sorted({t.name for t in _REGISTRY.values()}))


def store_dtype(cfg) -> torch.dtype:
    try:
        return STORE_DTYPES[cfg.store_dtype]
    except KeyError:
        raise ValueError(f"store_dtype {cfg.store_dtype!r} not in {sorted(STORE_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ScanContext:
    """Serve-step state a tier may derive scan operands from."""

    q_loc: torch.Tensor     # [q_row, d] query rows
    q_pad: torch.Tensor     # [q_row + 1, d] queries + sentinel row
    cd: torch.Tensor        # [q_row, B] query↔centroid squared distances
    b0: int                 # first partition of this rank's block
    b_loc: int              # partitions on this rank
    k: int                  # top-k depth of this serve step


class Tier:
    """The base tier: the exact f32 scan. ``cfg.store_dtype`` sets the vector
    plane's dtype (bfloat16 halves scan reads; distances accumulate in f32
    either way, and the quantized tiers' rerank upcasts to f32)."""

    name = "f32"
    aliases: tuple = ()

    def store_specs(self, cfg) -> dict:
        """Field name → (shape, dtype)."""
        b, c, d = cfg.n_partitions, cfg.capacity, cfg.dim
        return {"centroids": ((b, d), torch.float32),
                "vectors": ((b, c, d), store_dtype(cfg)),
                "ids": ((b, c), torch.int32),
                "occupancy": ((b, c), torch.bool)}

    def store_pspecs(self, cfg=None) -> dict:
        """Field name → the mesh axis its first dimension splits over."""
        del cfg
        return {"centroids": None, "vectors": "model", "ids": "model", "occupancy": "model"}

    def slot_fields(self, cfg) -> tuple:
        """Store fields indexed per (partition, slot): the planes a mutation
        moves together."""
        b, c = cfg.n_partitions, cfg.capacity
        return tuple(name for name, (shape, _) in self.store_specs(cfg).items()
                     if name != "centroids" and shape[:2] == (b, c))

    def build_store(self, cfg, store_h, *, generator=None):
        del generator
        ids = store_h.ids
        store = {"centroids": store_h.centroids,
                 "vectors": store_h.vectors.to(store_dtype(cfg)),
                 "ids": ids, "occupancy": ids >= 0}
        return store, cfg

    def encode_rows(self, cfg, store, x, parts) -> dict:
        """Content planes of new rows: slot field → [n, ...] tensor, ready to
        write into the slots the engine picked. ``x`` [n, d] f32 and
        ``parts`` [n] (each row's destination partition) are tensors on the
        store's device; ``ids`` and ``occupancy`` are the engine's
        bookkeeping, so a tier returns only its content planes."""
        del cfg, parts
        return {"vectors": x.to(store["vectors"].dtype)}

    def check_servable(self, cfg) -> None:
        """Any store carries the exact f32 operands."""
        del cfg

    def scan_kwargs(self, cfg, ctx: ScanContext, fields: dict) -> dict:
        del cfg, ctx, fields
        return {}


@register
class F32Tier(Tier):
    name = "f32"
    aliases = ("exact", "float32")


@register
class PqTier(Tier):
    """Two-stage quantized tier: one ADC LUT per query → a shortlist of
    ``rerank·k`` slots over the uint8 codes → exact f32 rerank
    (serving/quantized.py builds the store)."""

    name = "pq"
    aliases = ("quantized",)
    residual = False

    def store_specs(self, cfg) -> dict:
        from repro_torch.core.pq import code_dtype

        specs = super().store_specs(cfg)
        b, c = cfg.n_partitions, cfg.capacity
        specs["codes"] = ((b, c, cfg.pq_m), code_dtype(cfg.pq_ks))
        specs["codebooks"] = ((cfg.pq_m, cfg.pq_ks, cfg.dim // cfg.pq_m), torch.float32)
        return specs

    def store_pspecs(self, cfg=None) -> dict:
        sp = super().store_pspecs(cfg)
        sp["codes"] = "model"       # codes split with their vectors
        sp["codebooks"] = None      # replicated, as the centroids
        return sp

    def build_store(self, cfg, store_h, *, generator=None):
        from repro_torch.serving import quantized

        store, cfg = super().build_store(cfg, store_h)
        # default pq_m: the largest divisor of dim ≤ 16 (subspaces tile dim)
        m = cfg.pq_m or max(m for m in range(1, min(16, cfg.dim) + 1) if cfg.dim % m == 0)
        qs = quantized.build_quantized_store(
            store_h.vectors, store_h.ids, m=m, ks=cfg.pq_ks, residual=self.residual,
            centroids=store_h.centroids if self.residual else None, generator=generator)
        store["codes"], store["codebooks"] = qs.codes, qs.codebooks
        if self.residual:
            store["cterm"] = qs.cterm
        # ks may have been clamped for a small store
        return store, dataclasses.replace(cfg, pq_m=m, pq_ks=qs.ks)

    def encode_rows(self, cfg, store, x, parts) -> dict:
        from repro_torch.core import pq as pqmod

        rows = super().encode_rows(cfg, store, x, parts)
        cbs = store["codebooks"]
        book = pqmod.PQCodebook(codebooks=cbs, m=cbs.shape[0], ks=cbs.shape[1])
        x = x.float()
        if self.residual:
            # residual codes encode x − the DESTINATION partition's centroid;
            # at a row's own partition this repeats the build's arithmetic
            cents = store["centroids"][parts.long()].float()
            x = x - cents
        codes = pqmod.encode(book, x)
        rows["codes"] = codes.to(store["codes"].dtype)
        if self.residual:
            rows["cterm"] = pqmod.residual_cross_terms(book, cents, codes)
        return rows

    def check_servable(self, cfg) -> None:
        # residual codes encode x − centroid: a plain shared-LUT scan of them
        # would rank by distance to the residual — wrong answers, not an error
        if not self.residual and cfg.tier == "residual_pq":
            raise ValueError(
                "store codes are residual-encoded (built with tier='residual_pq'); "
                "serve tier='residual_pq' or the exact 'f32' fallback, not 'pq'")

    def scan_kwargs(self, cfg, ctx: ScanContext, fields: dict) -> dict:
        from repro_torch.serving import quantized

        codes, codebooks = fields["codes"], fields["codebooks"]
        rk = min(cfg.capacity, max(ctx.k, int(cfg.rerank) * ctx.k))
        # one LUT per query, valid in every partition; the zero row pairs
        # with q_pad's sentinel. The scan takes this compact plane and never
        # expands it per slot.
        lut_pad = torch.cat([quantized.adc_lut(codebooks, ctx.q_loc),
                             codebooks.new_zeros((1, codes.shape[-1], codebooks.shape[1]))])
        return {"lut_pad": lut_pad, "codes_loc": codes, "rk": rk}


@register
class ResidualPqTier(PqTier):
    """PQ over x − centroid: the code budget goes to the within-partition
    residual, paid for by a per-slot cterm plane and a per-(query,
    partition) offset taken from the probing distances."""

    name = "residual_pq"
    aliases = ("residual",)
    residual = True

    def store_specs(self, cfg) -> dict:
        specs = super().store_specs(cfg)
        specs["cterm"] = ((cfg.n_partitions, cfg.capacity), torch.float32)
        return specs

    def store_pspecs(self, cfg=None) -> dict:
        sp = super().store_pspecs(cfg)
        sp["cterm"] = "model"       # rides with its codes
        return sp

    def scan_kwargs(self, cfg, ctx: ScanContext, fields: dict) -> dict:
        kw = super().scan_kwargs(cfg, ctx, fields)
        # ‖c_b‖² − 2⟨q, c_b⟩ = cd − ‖q‖² per (query, partition), from the
        # probing distances over every partition; the rank takes its block's
        # columns. The zero row is the empty slot's
        off = ctx.cd - (ctx.q_loc * ctx.q_loc).sum(-1, keepdim=True)
        off_pad = torch.cat([off, off.new_zeros((1, off.shape[1]))])
        kw.update(cterm_loc=fields["cterm"],
                  off_loc=off_pad[:, ctx.b0:ctx.b0 + ctx.b_loc].T)
        return kw

