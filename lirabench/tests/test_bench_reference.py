"""The plain reference against a NumPy brute force in float64."""
from __future__ import annotations

import numpy as np
import pytest
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


INT_RANGES = {"uint8": (0, 256), "int8": (-128, 128)}


def _int_data(dtype, seed=2, n=900, q=37, d=20):
    """8-bit rows with runs of exact duplicates: more rows tie some queries'
    k-th neighbour than the reference keeps as candidates."""
    rng = np.random.default_rng(seed)
    lo, hi = INT_RANGES[dtype]
    base = rng.integers(lo, hi, size=(n, d)).astype(dtype)
    base[300:360] = base[7]
    base[500:540] = base[11]
    queries = rng.integers(lo, hi, size=(q, d)).astype(dtype)
    queries[:3] = base[[7, 11, 600]]
    return base, queries


def _int64_dists(base, queries):
    return ((queries[:, None, :].astype(np.int64) - base[None].astype(np.int64)) ** 2).sum(-1)


@pytest.mark.parametrize("dtype", list(INT_RANGES))
def test_exact_topk_on_integers_equals_an_int64_brute_force(dtype):
    base, queries = _int_data(dtype)
    k = 25
    d, i = reference.exact_topk(torch.from_numpy(base), torch.from_numpy(queries), k, block=8)
    full = _int64_dists(base, queries)
    # ascending by distance, then by id
    want = np.lexsort((np.broadcast_to(np.arange(len(base)), full.shape), full), axis=1)[:, :k]
    assert d.dtype == torch.float32
    # the k distances, to the bit
    np.testing.assert_array_equal(d.numpy().astype(np.int64), np.take_along_axis(full, want, 1))
    i = i.numpy()
    np.testing.assert_array_equal(np.take_along_axis(full, i, 1), d.numpy().astype(np.int64))
    assert all(len(set(row)) == k for row in i.tolist())
    # ties ordered by id; the ids are the brute force's wherever fewer rows
    # tie the k-th distance than the candidates hold
    assert (np.diff(i, axis=1)[np.diff(d.numpy(), axis=1) == 0] > 0).all()
    kth = np.take_along_axis(full, want[:, -1:], 1)
    settled = (full <= kth).sum(1) <= 2 * k
    assert settled[1:3].all() and settled.sum() > len(queries) // 2
    np.testing.assert_array_equal(i[settled], want[settled])
    # 61 rows at distance 0 from query 0: any 25 of them, in order of id
    assert not settled[0] and (d[0] == 0).all() and set(i[0]) <= {7, *range(300, 360)}


@pytest.mark.parametrize("dtype", list(INT_RANGES))
def test_pair_dists_on_integers_equals_int64(dtype):
    base, queries = _int_data(dtype, seed=3)
    # the widest gaps 8-bit values can hold
    lo, hi = INT_RANGES[dtype]
    base[0], queries[0] = lo, hi - 1
    ids = np.array([[0, 5, -1], [899, 3, 3]] + [[0, 1, 2]] * 3)[:len(queries)]
    q = queries[:len(ids)]
    got = reference.pair_dists(torch.from_numpy(base), torch.from_numpy(q), torch.from_numpy(ids))
    want = _int64_dists(base, q)[np.arange(len(q))[:, None], ids.clip(0)]
    ok = ids >= 0
    assert np.isnan(got.numpy()[0, 2])
    np.testing.assert_array_equal(got.numpy()[ok].astype(np.int64), want[ok])
    assert want[0, 0] == 255 ** 2 * base.shape[1]


def test_integer_vectors_outside_the_exact_range_are_refused():
    with pytest.raises(TypeError):
        reference.pair_dists(torch.zeros((4, 8), dtype=torch.int16), torch.zeros((1, 8)),
                             torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="258"):
        reference.exact_topk(torch.zeros((4, 259), dtype=torch.uint8),
                             torch.zeros((1, 259), dtype=torch.uint8), 2)
