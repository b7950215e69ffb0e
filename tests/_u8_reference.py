"""A plain integer brute force for byte rows, independent of the port: it
imports no kernel and no module of ``repro_torch``.

Distances are Σ(q − x)² in int64. The k nearest of a query are its rows
ordered by (distance, row id), the first k of them: among rows tied at a
distance the lower id comes first."""
from __future__ import annotations

import numpy as np


def sq_dists(queries: np.ndarray, base: np.ndarray) -> np.ndarray:
    """[Q, N] int64 Σ(q − x)² of every query against every row."""
    q = np.asarray(queries, np.int64)
    x = np.asarray(base, np.int64)
    return ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)


def topk(queries: np.ndarray, base: np.ndarray, k: int):
    """(dists [Q, k] int64, ids [Q, k] int64): each query's k nearest rows by
    (distance, id)."""
    d = sq_dists(queries, base)
    ids = np.broadcast_to(np.arange(d.shape[1]), d.shape)
    order = np.lexsort((ids, d), axis=1)[:, :k]
    return np.take_along_axis(d, order, 1), order
