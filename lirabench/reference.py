"""The plain reference: exact nearest neighbours and exact distances by brute
force, in full float32 (TF32 off for matmuls and cuDNN), in blocks so that it
fits beside nothing else on the card. It reads only the benchmark's own
vectors and, to judge them, the ids the system returned.

Vectors of 8-bit integers (``uint8``, ``int8``) are cast to f32 where they
are read. Every value, product and partial sum is then an integer below
2**24 while the width is at most 258 (255² · 258 < 2**24), so the f32
arithmetic is exact and the distances are those of int64 arithmetic to the
last bit. Rows that tie the k-th distance may outnumber the places left, so
which of them ``exact_topk`` returns is not fixed; the judge counts any of
them as a neighbour on integer data.
"""
from __future__ import annotations

import torch

# 255² · 258 < 2**24 < 255² · 259: the widest 8-bit rows whose f32 sums are exact
MAX_INT_DIM = 258


def full_precision() -> None:
    """Matmuls in full f32: TF32 would round the products to 10 mantissa bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def as_f32(x: torch.Tensor) -> torch.Tensor:
    """A float tensor as it is; 8-bit integers cast to f32, which is exact.
    Refuses integers that f32 sums of squares could not hold exactly."""
    if x.is_floating_point():
        return x
    if x.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"{x.dtype}: the reference is exact on uint8 and int8 vectors only")
    if x.shape[-1] > MAX_INT_DIM:
        raise ValueError(f"width {x.shape[-1]} > {MAX_INT_DIM}: f32 sums stop being exact")
    return x.float()


def sq_norms(base: torch.Tensor) -> torch.Tensor:
    """||x||² of every row of ``base``: [n] f32."""
    x = as_f32(base)
    return (x * x).sum(-1)


def pair_dists(base: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Squared L2 from each query row ``q`` [R, d] to the rows ``ids`` [R, c]
    of ``base``, summed as (q - x)^2 so no cancellation enters. Ids < 0 give
    NaN."""
    x = as_f32(base[ids.clamp_min(0).long()])                       # [R, c, d]
    d = ((x - as_f32(q)[:, None, :]) ** 2).sum(-1)
    return torch.where(ids >= 0, d, torch.nan)


def exact_topk(base: torch.Tensor, queries: torch.Tensor, k: int, *, block: int = 256,
               margin: int = 2) -> tuple:
    """The exact k nearest rows of ``base`` for each query: (dists [Q, k],
    ids [Q, k] int64), ascending by distance, then by id. A block's ``margin·k``
    candidates come from the ||q||² - 2 q·x + ||x||² expansion; their exact
    distances by ``pair_dists`` decide the order, so the expansion's rounding
    can only matter for a neighbour it ranks below ``margin·k``. On integer
    vectors the expansion is exact too, so the k distances are; among rows
    tied at the k-th distance the candidates are any of them."""
    full_precision()
    exact_int = not base.is_floating_point()
    if exact_int and queries.dtype != base.dtype:
        raise TypeError(f"queries {queries.dtype} against a {base.dtype} base")
    # integer rows go in centred on 0 (uint8 moved by -128): a shift changes
    # no distance and keeps each term of the expansion below 2**24
    shift = 128.0 if base.dtype == torch.uint8 else 0.0
    b = as_f32(base).sub_(shift) if exact_int else base
    b2 = (b * b).sum(-1)
    out_d, out_i = [], []
    kk = min(base.shape[0], margin * k)
    for s in range(0, queries.shape[0], block):
        q = queries[s:s + block]
        qf = as_f32(q).sub_(shift) if exact_int else q
        d2 = (qf @ b.T).mul_(-2.0).add_(b2[None, :]).add_((qf * qf).sum(-1, keepdim=True))
        cand = torch.topk(d2, kk, dim=1, largest=False).indices
        del d2
        exact = pair_dists(base, q, cand)
        # order by (distance, id): sort by id, then stably by distance
        cand, o = torch.sort(cand, dim=1)
        exact = torch.gather(exact, 1, o)
        exact, o = torch.sort(exact, dim=1, stable=True)
        out_d.append(exact[:, :k])
        out_i.append(torch.gather(cand, 1, o)[:, :k])
    return torch.cat(out_d), torch.cat(out_i)
