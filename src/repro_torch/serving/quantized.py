"""Quantized two-stage serving tier: PQ/ADC shortlist + exact f32 rerank
(counterpart of ``repro/serving/quantized.py``).

  stage 0 (per query, once): the ADC LUT [m, ks] of subspace distances;
  stage 1 (per probed partition): a LUT scan over the partition's codes keeps
          a shortlist of ``rk`` slots (``kernels.pq_adc_topk_qbuf``);
  stage 2: exact f32 distances on the shortlist only, then top-k and the
          usual replica-aware merge.

Non-residual codebooks are trained on the raw vectors, so one LUT per query
holds in every partition. Residual ones (``residual=True``) are trained on
x − centroid, and a per-slot plane ``cterm[b, n] = 2⟨c_b, decode(codes[b, n])⟩``
plus a per-(query, partition) offset restore the exact distance to the
reconstruction (core/pq.py). The f32 store stays resident as the rerank
operand.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import pq as pqmod

# slots encoded at once: bounds the [rows, m, ks] distances and the
# per-row centroid copies of a chunk
_ENCODE_ROWS = 1 << 18


class QuantizedStore(NamedTuple):
    """PQ codes per partition slot + the shared codebooks. Slots beyond a
    partition's fill hold real encodings of the padding vectors; the scan
    masks them by ``ids < 0``, as the f32 path does."""

    codes: torch.Tensor                   # [B, capacity, m] uint8 (ks ≤ 256) / uint16
    codebooks: torch.Tensor               # [m, ks, d_sub] f32
    cterm: Optional[torch.Tensor] = None  # [B, capacity] f32, residual stores only

    @property
    def ks(self) -> int:
        return self.codebooks.shape[1]


# per-query subspace distance tables [Q, m, ks] from raw codebook tensors
adc_lut = pqmod.adc_lut_raw


def build_quantized_store(vectors: torch.Tensor, ids: torch.Tensor, *, m: int = 16,
                          ks: int = 256, train_n: int = 32768, n_iters: int = 12,
                          residual: bool = False, centroids: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> QuantizedStore:
    """Train PQ on a sample of at most ``train_n`` valid slots of the padded
    store ``vectors`` [B, capacity, d] (ids [B, capacity], < 0 = padding),
    then encode every slot. ``ks`` is clamped to max(2, valid // 2) so tiny
    stores build. With ``residual=True`` the codebooks are trained on, and
    the codes encode, x − centroids[partition], and ``cterm`` is computed."""
    b, cap, d = vectors.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by pq_m={m}")
    if residual and centroids is None:
        raise ValueError("residual PQ needs the partition centroids")
    dev = vectors.device
    flat = vectors.reshape(-1, d)
    rows = torch.nonzero(ids.reshape(-1) >= 0).flatten()
    ks = int(min(ks, max(2, len(rows) // 2)))
    if len(rows) > train_n:
        pick = torch.randperm(len(rows), generator=generator, device=dev)[:train_n]
        rows = rows[pick]
    train = flat[rows].float()
    if residual:
        train = train - centroids[rows // cap].float()
    pq = pqmod.train_pq(train, m=m, ks=ks, n_iters=n_iters, generator=generator)

    codes = torch.empty((b, cap, m), dtype=pqmod.code_dtype(ks), device=dev)
    cterm = torch.empty((b, cap), dtype=torch.float32, device=dev) if residual else None
    step = max(1, _ENCODE_ROWS // cap)
    for b0 in range(0, b, step):
        x = vectors[b0:b0 + step].float()
        if residual:
            cents = centroids[b0:b0 + step, None, :].float().expand_as(x).reshape(-1, d)
            x = x.reshape(-1, d) - cents
        c = pqmod.encode(pq, x.reshape(-1, d))
        codes[b0:b0 + step] = c.reshape(-1, cap, m)
        if residual:
            cterm[b0:b0 + step] = pqmod.residual_cross_terms(pq, cents, c).reshape(-1, cap)
    return QuantizedStore(codes=codes, codebooks=pq.codebooks, cterm=cterm)


def scan_store_bytes(store: dict) -> dict:
    """Bytes each scan path reads per full pass over the store."""
    def nbytes(t):
        return t.numel() * t.element_size()

    out = {"f32": nbytes(store["vectors"])}
    if "codes" in store:
        q_bytes = nbytes(store["codes"]) + (nbytes(store["cterm"]) if "cterm" in store else 0)
        out["quantized"] = q_bytes
        out["ratio"] = out["f32"] / max(1, q_bytes)
    return out
