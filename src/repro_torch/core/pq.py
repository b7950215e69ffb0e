"""Product quantization (IVFPQ; Jégou et al. TPAMI'11); counterpart of
``repro/core/pq.py``.

Codes, codebooks and LUTs are tensors on the device of their inputs. Encoding
and decoding go in row batches, so a store of millions of slots never holds
its whole [N, m, ks] distance block or [N, d] reconstruction at once.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.kmeans import kmeans_fit, lloyd
from repro_torch.kernels import ref as _ref


class PQCodebook(NamedTuple):
    codebooks: torch.Tensor  # [m, ks, d_sub] f32
    m: int
    ks: int


def code_dtype(ks: int) -> torch.dtype:
    """Narrowest integer dtype that can hold a code in [0, ks)."""
    if ks <= 256:
        return torch.uint8
    if ks <= 65536:
        return torch.uint16
    return torch.int32


def train_pq(x: torch.Tensor, m: int = 16, ks: int = 256, n_iters: int = 15, *,
             generator: Optional[torch.Generator] = None,
             init: Optional[torch.Tensor] = None) -> PQCodebook:
    """k-means of ``ks`` codewords in each of the ``m`` subspaces of ``x``
    [N, d]: k-means++ seeding from ``generator``, or Lloyd from the initial
    codebooks ``init`` [m, ks, d_sub] (as ``lloyd`` starts the partitions)."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m}")
    xs = x.float().reshape(n, m, d // m)
    cbs = []
    for j in range(m):  # one subspace at a time keeps peak memory low
        if init is not None:
            st = lloyd(xs[:, j], torch.as_tensor(init[j], device=x.device), n_iters)
        else:
            st = kmeans_fit(xs[:, j].contiguous(), ks, n_iters, generator=generator)
        cbs.append(st.centroids)
    return PQCodebook(codebooks=torch.stack(cbs), m=m, ks=ks)


def _subspace_d2(codebooks: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """[n, m, d_sub] rows × [m, ks, d_sub] codebooks → [n, m, ks] squared
    distances, by the ‖x‖² − 2x·c + ‖c‖² expansion."""
    dot = torch.bmm(xs.transpose(0, 1), codebooks.transpose(1, 2)).transpose(0, 1)
    return ((xs * xs).sum(-1)[..., None] - 2.0 * dot
            + (codebooks * codebooks).sum(-1)[None])


def encode(pq: PQCodebook, x: torch.Tensor, *, batch: int = 8192) -> torch.Tensor:
    """x [N, d] → codes [N, m] in ``code_dtype(ks)``, the nearest codeword of
    each subspace (the first on a tie, as ``jnp.argmin``)."""
    n, d = x.shape
    cb = pq.codebooks.to(x.device)
    out = torch.empty((n, pq.m), dtype=code_dtype(pq.ks), device=x.device)
    for s in range(0, n, batch):
        xb = x[s:s + batch].float().reshape(-1, pq.m, d // pq.m)
        out[s:s + batch] = torch.argmin(_subspace_d2(cb, xb), -1).to(out.dtype)
    return out


def decode(pq: PQCodebook, codes: torch.Tensor, *, batch: int = 65536) -> torch.Tensor:
    """codes [N, m] → reconstructed vectors [N, d] f32."""
    n = codes.shape[0]
    cb = pq.codebooks.to(codes.device)
    sub = torch.arange(pq.m, device=codes.device)[None, :]
    out = torch.empty((n, pq.m * cb.shape[-1]), dtype=torch.float32, device=codes.device)
    for s in range(0, n, batch):
        out[s:s + batch] = cb[sub, codes[s:s + batch].long()].reshape(-1, out.shape[1])
    return out


def adc_lut_raw(codebooks: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-query LUT of subspace distances from a raw [m, ks, d_sub] codebook
    tensor: [Q, m, ks]."""
    return _subspace_d2(codebooks, q.float().reshape(q.shape[0], codebooks.shape[0], -1))


def adc_lut(pq: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """Per-query LUT of subspace distances: [Q, m, ks]."""
    return adc_lut_raw(pq.codebooks, q)


def adc_distances(pq: PQCodebook, q: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact ADC: dist[q, n] = Σ_m LUT[q, m, codes[n, m]] → [Q, N]."""
    return _ref.pq_adc_ref(adc_lut(pq, q), codes)


# --------------------------------------------------------------- residual PQ
#
# With codes over x − c_b, the exact distance to the reconstruction c_b + r̂
# splits into a LUT over the residual codebooks at the raw query (shared by
# every partition), a per-(query, partition) scalar and a per-slot scalar:
#
#   ‖q − (c_b + r̂)‖² = Σ_m lut[q, m, code_m] + (‖c_b‖² − 2⟨q, c_b⟩) + 2⟨c_b, r̂⟩
#
# The store keeps the last term (``residual_cross_terms``); the serve step
# takes the middle one from its probing distances (cd − ‖q‖²).


def residual_query_offsets(centroids: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """off[q, b] = ‖c_b‖² − 2⟨q, c_b⟩ = ‖q − c_b‖² − ‖q‖²: [Q, B]."""
    return (centroids * centroids).sum(-1)[None, :] - 2.0 * q @ centroids.T


def residual_cross_terms(pq: PQCodebook, centroids_per_row: torch.Tensor,
                         codes: torch.Tensor, *, batch: int = 65536) -> torch.Tensor:
    """cterm[n] = 2⟨c_n, decode(codes_n)⟩, with ``centroids_per_row`` [N, d]
    each row's partition centroid: [N] f32."""
    n = codes.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    for s in range(0, n, batch):
        recon = decode(pq, codes[s:s + batch])
        out[s:s + batch] = 2.0 * (centroids_per_row[s:s + batch].float() * recon).sum(-1)
    return out
