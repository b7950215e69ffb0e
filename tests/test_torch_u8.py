"""The u8 tier: byte rows served with exact integer distances.

The engine (``LiraEngine.build`` / ``search`` with ``tier="u8"``) is held
against the plain integer brute force of ``_u8_reference.py`` on the CPU;
the plain version of the scan (``ref.l2u8_topk_qbuf_ref``) against int64
sums at edge shapes; on the card (``cuda`` tests, skipped elsewhere) the
kernel ``l2u8_topk_qbuf`` against the plain version, bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from _u8_reference import sq_dists, topk
from repro_torch.core import partitions
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.serving import api, tiers
from repro_torch.serving.engine import LiraEngine

N, DIM, B, K = 4096, 128, 16, 10


def _bytes(rng, centres, n):
    rows = centres[rng.integers(0, len(centres), n)] + rng.normal(0, 12, (n, centres.shape[1]))
    return np.clip(rows, 0, 255).round().astype(np.uint8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centres = rng.integers(20, 236, (12, DIM)).astype(np.float64)
    return _bytes(rng, centres, N), _bytes(rng, centres, 64), centres


def _build(base, **kw):
    bc = api.BuildConfig(n_partitions=B, k=K, tier="u8", train_frac=0.2, epochs=2, impl="ref",
                         nprobe_max=B, **kw)
    return LiraEngine.build(base, bc, device="cpu")


@pytest.fixture(scope="module")
def engine(data):
    return _build(data[0])


def _assert_exact(res, queries, base, k=K):
    """Distances equal to the brute force's to the bit; ids the same but
    among rows tied at the k-th distance, and each at its exact distance."""
    gd, gi = topk(queries, base, k)
    np.testing.assert_array_equal(res.dists, gd.astype(np.float32))
    assert (res.ids >= 0).all() and all(len(set(r)) == k for r in res.ids)
    exact = np.take_along_axis(sq_dists(queries, base), res.ids.astype(np.int64), 1)
    np.testing.assert_array_equal(exact, gd)
    # ids strictly inside the k-th distance are the brute force's exactly
    inside = gd < gd[:, -1:]
    np.testing.assert_array_equal(np.where(inside, res.ids, -1), np.where(inside, gi, -1))


def test_search_equals_the_integer_brute_force(engine, data):
    base, queries, _ = data
    res = engine.search(queries, sigma=-1.0)
    assert res.dists.dtype == np.float32 and res.stats.tier == "u8"
    _assert_exact(res, queries, base)


def test_every_partition_probed_reads_recall_one(engine, data):
    """Recall counts a returned row at the k-th distance or nearer, as the
    benchmark counts ties on integer data."""
    base, queries, _ = data
    res = engine.search(queries, sigma=-1.0)
    gd, _ = topk(queries, base, K)
    exact = np.take_along_axis(sq_dists(queries, base), res.ids.astype(np.int64), 1)
    assert (res.ids >= 0).all() and (exact <= gd[:, -1:]).all()


def test_tied_rows_differ_only_at_the_kth_distance(data):
    """Copies of one row under other ids: rows tied at the k-th distance may
    come back as any of the copies, every other id as the brute force has
    it."""
    base, queries, _ = data
    tied = base.copy()
    tied[1000:1040] = tied[7]                    # 41 copies of row 7
    q = np.repeat(tied[7:8], 4, 0)
    res = _build(tied).search(q, sigma=-1.0)
    gd, _ = topk(q, tied, K)
    assert (gd == 0).all()                       # every one of the k nearest is a copy
    assert set(res.ids.ravel()) <= {7, *range(1000, 1040)}
    assert (res.dists == 0).all() and all(len(set(r)) == K for r in res.ids)


def test_float_queries_are_refused(engine, data):
    with pytest.raises(ValueError, match="uint8 queries"):
        engine.search(data[1].astype(np.float32))
    with pytest.raises(ValueError, match="tier='u8'"):
        engine.search(data[1], tier="f32")


def test_the_store_holds_bytes_and_their_norms(engine):
    store, cfg = engine.store, engine.cfg
    assert store["vectors"].dtype == torch.uint8 and store["sqnorm"].dtype == torch.int32
    want = (store["vectors"].long() ** 2).sum(-1)
    assert torch.equal(store["sqnorm"].long(), want)
    assert tiers.resolve("u8").store_pspecs(cfg)["sqnorm"] == "model"
    assert "sqnorm" in tiers.resolve("u8").slot_fields(cfg)
    # padding is masked by its id, whatever its bytes
    pad = store["ids"] == partitions.PAD_ID
    assert bool(pad.any()) and not bool(store["occupancy"][pad].any())


def test_insert_and_delete(data):
    base, queries, centres = data
    eng = _build(base[:2048])
    rng = np.random.default_rng(5)
    new = _bytes(rng, centres, 32)
    eng.insert(new, np.arange(5000, 5032))
    res = eng.search(new, sigma=-1.0)
    assert (res.dists[:, 0] == 0).all() and set(res.ids[:, 0]) <= set(range(5000, 5032)) | set(
        range(2048))
    assert eng.store["sqnorm"].dtype == torch.int32
    # the new rows' ids are 5000 on: rows 2048 on of the brute force's base
    both = np.concatenate([base[:2048], new])
    got = eng.search(queries, sigma=-1.0)
    ids = np.where(got.ids >= 5000, got.ids - 5000 + 2048, got.ids)
    gd, _ = topk(queries, both, K)
    np.testing.assert_array_equal(got.dists, gd.astype(np.float32))
    np.testing.assert_array_equal(np.take_along_axis(sq_dists(queries, both), ids, 1), gd)
    assert eng.delete(np.arange(5000, 5032)) >= 32
    assert not (eng.search(new, sigma=-1.0).ids >= 5000).any()
    with pytest.raises(ValueError, match="whole numbers"):
        eng.insert(new.astype(np.float32) + 0.5, np.arange(6000, 6032))


def test_save_and_load_round_trip(engine, data, tmp_path):
    engine.save(tmp_path)
    back = LiraEngine.load(tmp_path, device="cpu")
    assert back.cfg.tier == "u8" and back.cfg.impl == "ref"
    for name, plane in engine.store.items():
        assert back.store[name].dtype == plane.dtype and torch.equal(back.store[name], plane)
    a, b = engine.search(data[1]), back.search(data[1])
    np.testing.assert_array_equal(a.dists, b.dists)
    np.testing.assert_array_equal(a.ids, b.ids)


def test_widths_past_exact_f32_are_refused(engine):
    wide = dataclasses.replace(engine.cfg, dim=tiers.U8_MAX_DIM + 1)
    with pytest.raises(ValueError, match="widths up to 258"):
        tiers.resolve("u8").check_servable(wide)
    tiers.resolve("u8").check_servable(dataclasses.replace(engine.cfg, dim=tiers.U8_MAX_DIM))


@pytest.mark.parametrize("rows", [np.array([[1.5, 2.0]]), np.array([[-1.0, 2.0]]),
                                  np.array([[256, 0]])])
def test_rows_that_are_not_bytes_are_refused(rows):
    with pytest.raises(ValueError, match="whole numbers"):
        tiers.as_bytes(torch.as_tensor(rows))


# ------------------------------------------------------------ build_store

def _store_inputs(seed=1, n=200, b=6, d=8):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, d)).astype(np.float32)
    assign = rng.integers(0, b, n)
    cents = rng.normal(size=(b, d)).astype(np.float32)
    extra_rows = rng.integers(0, n, 30)
    extra = (x[extra_rows], extra_rows.astype(np.int32), rng.integers(0, b, 30).astype(np.int32))
    return x, np.arange(n, dtype=np.int32), assign, cents, extra


def _store_by_loop(x, ids, assign, cents, extra, pad):
    """The reference's per-row loop: originals then replicas, each partition
    in input order, padded with ``pad`` and PAD_ID."""
    rows = [(x[i], ids[i], assign[i]) for i in range(len(x))]
    rows += [(extra[0][i], extra[1][i], extra[2][i]) for i in range(len(extra[0]))]
    b, d = cents.shape[0], x.shape[1]
    per = [[(v, i) for v, i, a in rows if a == p] for p in range(b)]
    cap = max(len(r) for r in per)
    vec = np.full((b, cap, d), pad, np.float64)
    pid = np.full((b, cap), partitions.PAD_ID, np.int32)
    for p, r in enumerate(per):
        for s, (v, i) in enumerate(r):
            vec[p, s], pid[p, s] = v, i
    return vec, pid


def test_build_store_f32_is_the_per_row_layout():
    x, ids, assign, cents, extra = _store_inputs()
    st = partitions.build_store(x, ids, assign, cents, extra=extra, device="cpu")
    vec, pid = _store_by_loop(x, ids, assign, cents, extra, 1e6)
    assert st.vectors.dtype == torch.float32
    assert torch.equal(st.vectors, torch.as_tensor(vec, dtype=torch.float32))
    assert torch.equal(st.ids, torch.as_tensor(pid))
    same = partitions.build_store(x, ids, assign, cents, extra=extra, device="cpu",
                                  dtype=torch.float32)
    assert torch.equal(same.vectors, st.vectors) and torch.equal(same.ids, st.ids)


def test_build_store_in_bytes_pads_with_zeros_under_pad_ids():
    x, ids, assign, cents, extra = _store_inputs()
    st = partitions.build_store(x.astype(np.uint8), ids, assign, cents, device="cpu",
                                extra=(extra[0].astype(np.uint8), extra[1], extra[2]),
                                dtype=torch.uint8)
    vec, pid = _store_by_loop(x, ids, assign, cents, extra, 0)
    assert st.vectors.dtype == torch.uint8
    assert torch.equal(st.vectors, torch.as_tensor(vec).to(torch.uint8))
    assert torch.equal(st.ids, torch.as_tensor(pid))
    pad = st.ids == partitions.PAD_ID
    assert bool(pad.any()) and not bool(st.vectors[pad].any())


# ------------------------------------------------------------ the scan at edge shapes

U8_CASES = {
    "holes+padding": {},
    "k>C": dict(c=6, pad_tail=2),
    "empty-slot rows": dict(empty_frac=0.8),
    "all ids padding": dict(hole_frac=1.0),
    "equal rows": dict(rows="equal", hole_frac=0.0, pad_tail=0),
    "few values": dict(rows="few", s=40),
    "width 64": dict(d=64),
    "width 256": dict(d=256, rows="extreme"),
    "k 100": dict(b=8, s=16, c=300, k=100, n_rows=300),
    # one bucket with 80 slots all occupied and 10,000 candidates, no hole:
    # several slot groups, each cut into candidate ranges, so the merge runs
    "hot bucket": dict(s=80, c=10_000, hot=True),
}


def u8_case(case: str, seed: int):
    """(q_pad [R, d] uint8, qbuf [B, S] int32, cands [B, C, d] uint8, sqnorm
    [B, C] int32, ids [B, C] int32), k. Bucket 0 has no valid candidate and
    the last bucket no occupied slot; row R - 1 is the empty slots' (zeros)."""
    kw = {**dict(b=4, s=24, c=300, d=128, n_rows=40, k=10, hole_frac=0.15, pad_tail=None,
                 empty_frac=0.3, rows="random", hot=False), **U8_CASES[case]}
    b, s, c, d, n_rows = (kw[n] for n in ("b", "s", "c", "d", "n_rows"))
    rng = np.random.default_rng(seed)
    hi = {"random": 256, "few": 3, "equal": 256, "extreme": 256}[kw["rows"]]
    q = rng.integers(0, hi, (n_rows, d)).astype(np.uint8)
    cands = rng.integers(0, hi, (b, c, d)).astype(np.uint8)
    if kw["rows"] == "equal":
        cands[:] = cands[0, 0]
    if kw["rows"] == "extreme":          # the largest distances there are: 255² · d
        q[::2], cands[:, ::2] = 0, 255
    q_pad = np.concatenate([q, np.zeros((1, d), np.uint8)])
    ids = rng.permutation(b * c).reshape(b, c).astype(np.int32)
    ids[rng.random((b, c)) < kw["hole_frac"]] = -1
    pad = c // 6 if kw["pad_tail"] is None else kw["pad_tail"]
    if pad:
        ids[:, -pad:] = -1
    ids[0] = -1
    qbuf = rng.integers(0, n_rows, (b, s)).astype(np.int32)
    qbuf[rng.random((b, s)) < kw["empty_frac"]] = n_rows
    if kw["hot"]:
        qbuf[1] = rng.integers(0, n_rows, s)
        ids[1] = rng.permutation(b * c)[:c]
    qbuf[-1] = n_rows
    sqnorm = (cands.astype(np.int64) ** 2).sum(-1).astype(np.int32)
    return (q_pad, qbuf, cands, sqnorm, ids), kw["k"]


def _int64_scan(q_pad, qbuf, cands, ids, k):
    """Each slot's k smallest Σ(q − x)² by (distance, position), inf / -1
    past the valid candidates: int64 sums over the bytes."""
    b, s = qbuf.shape
    out_d = np.full((b, s, k), np.inf, np.float32)
    out_i = np.full((b, s, k), -1, np.int32)
    for p in range(b):
        d2 = sq_dists(q_pad[qbuf[p]], cands[p])                     # [S, C]
        for j in range(s):
            valid = np.flatnonzero(ids[p] >= 0)
            order = valid[np.argsort(d2[j, valid], kind="stable")][:k]
            out_d[p, j, :len(order)] = d2[j, order]
            out_i[p, j, :len(order)] = ids[p, order]
    return out_d, out_i


@pytest.mark.parametrize("case", list(U8_CASES))
def test_plain_scan_equals_int64_sums(case):
    arrays, k = u8_case(case, seed=3)
    q_pad, qbuf, cands, sqnorm, ids = (torch.from_numpy(a) for a in arrays)
    got_d, got_i = tref.l2u8_topk_qbuf_ref(q_pad, qbuf, cands, sqnorm, ids, k)
    want_d, want_i = _int64_scan(*(arrays[i] for i in (0, 1, 2, 4)), k)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # the op takes the plain version for CPU tensors, whatever impl
    for impl in ("ref", "cuda"):
        d2, i2 = kops.l2u8_topk_qbuf(q_pad, qbuf, cands, sqnorm, ids, k, impl=impl)
        assert torch.equal(d2, got_d) and torch.equal(i2, got_i)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(U8_CASES))
def test_kernel_equals_plain_bit_for_bit(cuda_device, case):
    from repro_torch.kernels import l2u8_topk

    arrays, k = u8_case(case, seed=4)
    q_pad, qbuf, cands, sqnorm, ids = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    before = l2u8_topk.launches
    kd, ki = l2u8_topk.l2u8_topk_qbuf(q_pad, qbuf, cands, sqnorm, ids, k)
    torch.cuda.synchronize()
    assert l2u8_topk.launches == before + 1
    pd, pi = tref.l2u8_topk_qbuf_ref(q_pad, qbuf, cands, sqnorm, ids, k)
    occ = qbuf < q_pad.shape[0] - 1
    assert bool(torch.isinf(kd[~occ]).all()) and bool((ki[~occ] == -1).all())
    assert torch.equal(kd[occ], pd[occ])
    assert torch.equal(ki[occ], pi[occ])


@pytest.mark.cuda
def test_serve_step_on_the_card_equals_plain(cuda_device, data):
    base, queries, _ = data
    bc = api.BuildConfig(n_partitions=B, k=K, tier="u8", train_frac=0.2, epochs=2,
                         nprobe_max=B)
    eng = LiraEngine.build(base, bc, device=cuda_device)
    got = eng.search(queries, sigma=-1.0, impl="cuda")
    want = eng.search(queries, sigma=-1.0, impl="ref")
    np.testing.assert_array_equal(got.dists, want.dists)
    np.testing.assert_array_equal(got.ids, want.ids)
    _assert_exact(got, queries, base)
