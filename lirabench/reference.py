"""The plain reference: exact nearest neighbours and exact distances by brute
force, in full float32 (TF32 off for matmuls and cuDNN), in blocks so that it
fits beside nothing else on the card. It reads only the benchmark's own
vectors and, to judge them, the ids the system returned.
"""
from __future__ import annotations

import torch


def full_precision() -> None:
    """Matmuls in full f32: TF32 would round the products to 10 mantissa bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def pair_dists(base: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Squared L2 from each query row ``q`` [R, d] to the rows ``ids`` [R, c]
    of ``base``, summed as (q - x)^2 so no cancellation enters. Ids < 0 give
    NaN."""
    x = base[ids.clamp_min(0).long()]                               # [R, c, d]
    d = ((x - q[:, None, :]) ** 2).sum(-1)
    return torch.where(ids >= 0, d, torch.nan)


def exact_topk(base: torch.Tensor, queries: torch.Tensor, k: int, *, block: int = 256,
               margin: int = 2) -> tuple:
    """The exact k nearest rows of ``base`` for each query: (dists [Q, k],
    ids [Q, k] int64), ascending by distance, then by id. A block's ``margin·k``
    candidates come from the ||q||² - 2 q·x + ||x||² expansion; their exact
    distances by ``pair_dists`` decide the order, so the expansion's rounding
    can only matter for a neighbour it ranks below ``margin·k``."""
    full_precision()
    b2 = (base * base).sum(-1)
    out_d, out_i = [], []
    kk = min(base.shape[0], margin * k)
    for s in range(0, queries.shape[0], block):
        q = queries[s:s + block]
        d2 = (q @ base.T).mul_(-2.0).add_(b2[None, :]).add_((q * q).sum(-1, keepdim=True))
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
