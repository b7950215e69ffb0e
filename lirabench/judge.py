"""The comparison that decides ``correct``.

Every answer the window produced is judged against the plain reference
(``reference.py``), which is worked out from the benchmark's own vectors
after the system under test has been freed:
  * ``recall``: recall@k against the exact top-k over a sample of the
    answered rows drawn from the run's seed (``sample`` rows, or every row
    of a smaller window), a missing id (-1) counting as a miss. Probing,
    dispatch, the scan and the merge all decide it. On 8-bit integer
    vectors, where distances tie often and are exact, a returned id counts
    when its distance is at most the exact k-th (as BIG-ANN counts ties).
  * ``dist_gap``: the widest gap, over every returned (query, id), between
    the distance the system reports and the exact f32 distance from that
    query to that id, as a share of ||q||² + ||x||² (the scale of the
    rounding of the L2 expansion). An id or a distance altered where it is
    produced, a row handed back to the wrong request, or the vectors served
    at a lower precision than the configuration states all widen it. On
    8-bit integer vectors the exact distances are whole numbers that an
    exact system reports to the bit, so an integer configuration may hold
    ``dist_gap`` to 0.
  * ``dup_ids``: answered rows holding one id twice (the merge collapses
    replicas); ``unsorted``: rows whose distances are not ascending;
    ``bad_ids``: ids outside the base; ``unanswered``: queries due in the
    window that got no answer. Each is held to 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lirabench import reference


@dataclasses.dataclass
class Answers:
    """The window's answers, one row a query: ``pool`` [R] indices into the
    query pool, ``ids`` / ``dists`` [R, k] as the system returned them."""
    pool: np.ndarray
    ids: np.ndarray
    dists: np.ndarray
    unanswered: int = 0


def _rows(answers: Answers, block: int):
    for s in range(0, len(answers.pool), block):
        yield (answers.pool[s:s + block], answers.ids[s:s + block],
               answers.dists[s:s + block])


@torch.no_grad()
def judge(answers: Answers, base: torch.Tensor, pool: torch.Tensor, *, k: int,
          limits: dict, seed: int, sample: int, block: int = 4096) -> dict:
    """The compared numbers, each with its limit: ``{name: {"value", "limit",
    "ok"}}``. ``limits`` holds ``recall`` (the least allowed) and
    ``dist_gap`` (the most allowed)."""
    reference.full_precision()
    dev = base.device
    n = base.shape[0]
    rows = len(answers.pool)
    rng = np.random.default_rng([int(seed), 2])
    pick = np.sort(rng.choice(rows, size=min(int(sample), rows), replace=False))
    hits = 0.0
    if rows:
        used, where = np.unique(answers.pool[pick], return_inverse=True)
        queries = pool[torch.as_tensor(used, device=dev)]
        gt_d, gt = reference.exact_topk(base, queries, k)
        at = torch.as_tensor(where.reshape(-1), device=dev)
        ids = torch.as_tensor(answers.ids[pick], device=dev).long()
        ids = torch.where((ids >= n) | (ids < 0), -1, ids)
        if base.is_floating_point():
            gt = gt[at]
            hit = ((ids[:, :, None] == gt[:, None, :]) & (ids >= 0)[:, :, None]).any(-1)
        else:
            # exact distances: a row at the k-th distance or nearer is one of
            # the k nearest, whichever of the tied rows it is
            hit = reference.pair_dists(base, queries[at], ids) <= gt_d[at, k - 1:]
        hits = float(hit.sum())
        del ids, gt, gt_d, hit
    b2 = reference.sq_norms(base)
    gap = 0.0
    dup = unsorted = bad = 0
    for p, ids, dists in _rows(answers, block):
        p = torch.as_tensor(p, device=dev).long()
        ids = torch.as_tensor(ids, device=dev).long()
        dists = torch.as_tensor(dists, device=dev).float()
        bad += int(((ids >= n) | (ids < -1)).sum())
        ids = torch.where(ids >= n, -1, ids)
        valid = ids >= 0
        q = reference.as_f32(pool[p])
        exact = reference.pair_dists(base, q, ids)
        scale = (q * q).sum(-1)[:, None] + b2[ids.clamp_min(0)]
        if not base.is_floating_point():
            # a whole number, 0 only where the distance is 0 too: 1 there,
            # so that 0 / 0 does not read as NaN
            scale = scale.clamp_min(1.0)
        rel = torch.where(valid, (dists - exact).abs() / scale, 0.0)
        # a NaN or an infinite distance on a valid id is as wrong as it gets
        rel = torch.where(valid & ~torch.isfinite(dists), torch.inf, rel)
        gap = max(gap, float(rel.max()) if rel.numel() else 0.0)
        s = torch.sort(torch.where(valid, ids, -1), dim=1).values
        dup += int(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any(1).sum())
        d = torch.where(valid, dists, torch.inf)
        unsorted += int((d[:, 1:] < d[:, :-1]).any(1).sum())
    recall = hits / (len(pick) * k) if rows else 0.0
    checks = {
        "recall": {"value": recall, "limit": limits["recall"], "ok": rows > 0 and recall >= limits["recall"]},
        "dist_gap": {"value": gap, "limit": limits["dist_gap"], "ok": gap <= limits["dist_gap"]},
        "dup_ids": {"value": dup, "limit": 0, "ok": dup == 0},
        "unsorted": {"value": unsorted, "limit": 0, "ok": unsorted == 0},
        "bad_ids": {"value": bad, "limit": 0, "ok": bad == 0},
        "unanswered": {"value": answers.unanswered, "limit": 0, "ok": answers.unanswered == 0},
    }
    return checks
