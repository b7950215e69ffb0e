"""The plain reference against a NumPy brute force in float64."""
from __future__ import annotations

import numpy as np
import torch

from lirabench import reference


def _data(seed=0, n=700, q=33, d=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(q, d)).astype(np.float32))


def test_exact_topk_matches_numpy_brute_force():
    base, queries = _data()
    k = 20
    d, i = reference.exact_topk(torch.from_numpy(base), torch.from_numpy(queries), k, block=8)
    full = ((queries[:, None, :].astype(np.float64) - base[None].astype(np.float64)) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :k]
    assert i.dtype == torch.int64 and i.shape == (33, k)
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(full, want, 1), rtol=1e-5)


def test_exact_topk_orders_ties_by_id():
    base = np.zeros((10, 4), np.float32)
    base[[7, 2, 5]] = 1.0          # three rows at the same distance
    q = np.ones((1, 4), np.float32)
    _, i = reference.exact_topk(torch.from_numpy(base), torch.from_numpy(q), 3)
    assert i.tolist() == [[2, 5, 7]]


def test_pair_dists_matches_numpy_and_marks_missing_ids():
    base, queries = _data(1)
    ids = np.array([[0, 5, -1], [699, 3, 3]])
    q = queries[:2]
    got = reference.pair_dists(torch.from_numpy(base), torch.from_numpy(q),
                               torch.from_numpy(ids)).numpy()
    want = ((q[:, None, :].astype(np.float64) - base[ids.clip(0)].astype(np.float64)) ** 2).sum(-1)
    assert np.isnan(got[0, 2])
    ok = ids >= 0
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6)


def test_full_precision_turns_tf32_off():
    reference.full_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
