"""The serve step's compact merge, on the CPU: each query's dispatched top-k
lists gathered into a [q_row, nprobe_max·k] pool and ``dedup_topk`` counting
its duplicate ids, held bit for bit against the dense merge it replaced (a
[q_row + 1, b_loc, k] pool scattered from the dispatch buffer, its ids
sorted for the count), which lives here only as the oracle; and the plain
``dedup_topk``'s count against a NumPy count."""

import numpy as np
import pytest
import torch

from repro_torch import testing as rt
from repro_torch.configs.base import LiraSystemConfig
from repro_torch.core import probing
from repro_torch.kernels import dedup_topk as dd_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.serving import scan
from repro_torch.serving.engine import make_serve_step, place_ranks
from repro_torch.serving.quantized import build_quantized_store

B, CAP, DIM, K, NPROBE, OWN, COPIES, NQ = 8, 32, 16, 5, 4, 24, 6, 32


@pytest.fixture(scope="module")
def stores():
    """One partition layout in each tier: every partition holds OWN points,
    replicas of its neighbour's first COPIES points (same vectors, same
    ids) and two free slots; and NQ queries."""
    rng = np.random.default_rng(23)
    own = rng.normal(0, 1, (B, OWN, DIM)).astype(np.float32)
    vecs = np.zeros((B, CAP, DIM), np.float32)
    ids = np.full((B, CAP), -1, np.int32)
    for p in range(B):
        nb = (p + 1) % B
        vecs[p, :OWN], ids[p, :OWN] = own[p], np.arange(OWN) + p * OWN
        vecs[p, OWN:OWN + COPIES] = own[nb, :COPIES]
        ids[p, OWN:OWN + COPIES] = np.arange(COPIES) + nb * OWN
    vecs, ids = torch.from_numpy(vecs), torch.from_numpy(ids)
    base = {"centroids": torch.from_numpy(own.mean(1)), "vectors": vecs, "ids": ids,
            "occupancy": ids >= 0}
    qs = build_quantized_store(vecs, ids, m=4, ks=16,
                               generator=torch.Generator().manual_seed(1))
    qr = build_quantized_store(vecs, ids, m=4, ks=16, residual=True,
                               centroids=base["centroids"],
                               generator=torch.Generator().manual_seed(1))
    model = probing.ProbingModel(probing.ProbingConfig(dim=DIM, n_partitions=B),
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    out = {"f32": base,
           "pq": {**base, "codes": qs.codes, "codebooks": qs.codebooks},
           "residual_pq": {**base, "codes": qr.codes, "codebooks": qr.codebooks,
                           "cterm": qr.cterm}}
    queries = torch.from_numpy(rng.normal(0, 1, (NQ, DIM)).astype(np.float32))
    return out, model, queries


def _dense_dup_count(ids_pool):
    s = torch.sort(ids_pool, dim=1).values
    valid = s >= 0
    first = torch.ones_like(valid)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    return (valid.sum(1) - (valid & first).sum(1)).sum()


def _dense_merge(scans, q_row, k):
    """The dense merge over the scans each rank ran (in rank order): every
    rank's [q_row + 1, b_loc, k] pool, the empty slots' row cut off, merged
    and counted; over two ranks, the ranks' lists gathered and merged and
    counted again."""
    lists, hits = [], 0
    for qbuf, dists, rids in scans:
        b_loc = qbuf.shape[0]
        out_d = torch.full((q_row + 1, b_loc, k), torch.inf)
        out_i = torch.full((q_row + 1, b_loc, k), -1, dtype=torch.int32)
        cols = torch.arange(b_loc)[:, None].expand_as(qbuf)
        out_d[qbuf.long(), cols] = dists
        out_i[qbuf.long(), cols] = rids
        pool_d, pool_i = out_d[:q_row].reshape(q_row, -1), out_i[:q_row].reshape(q_row, -1)
        hits += int(_dense_dup_count(pool_i))
        lists.append(tref.dedup_topk_ref(pool_d, pool_i, k))
    if len(lists) == 1:
        return lists[0][0], lists[0][1], hits
    all_d, all_i = torch.cat([l[0] for l in lists], 1), torch.cat([l[1] for l in lists], 1)
    hits += int(_dense_dup_count(all_i))
    d, i = tref.dedup_topk_ref(all_d, all_i, k)
    return d, i, hits


@pytest.mark.parametrize("q_cap_factor", [2.0, 0.5])
@pytest.mark.parametrize("sigma", [-1.0, 0.5])
@pytest.mark.parametrize("model_n", [1, 2])
@pytest.mark.parametrize("tier", ["f32", "pq", "residual_pq"])
def test_compact_merge_equals_the_dense_merge(stores, monkeypatch, tier, model_n, sigma,
                                              q_cap_factor):
    """Answers and ``dedup_hits`` equal, bit for bit, those of the dense
    scatter, its id sort's count and ``dedup_topk``; a factor of 0.5 makes
    q_cap 8, under the 16 probes a partition gets on average at σ −1."""
    store, model, queries = stores
    cfg = LiraSystemConfig(arch="t", dim=DIM, n_partitions=B, capacity=CAP, k=K,
                           nprobe_max=NPROBE, pq_m=4, pq_ks=16, rerank=2, tier=tier,
                           q_cap_factor=q_cap_factor)
    scans = []
    inner = scan.run

    def kept(impl, qbuf, *args, **kw):
        out = inner(impl, qbuf, *args, **kw)
        scans.append((qbuf.clone(), out[0].clone(), out[1].clone()))
        return out

    monkeypatch.setattr(scan, "run", kept)
    mesh = make_test_mesh(1, model_n, device="cpu")
    step = make_serve_step(cfg, NQ, sigma=sigma, impl="ref", k=K, mesh=mesh)
    valid = torch.arange(NQ) < NQ - 3                   # three padding rows
    d, i, _, overflow, hits = step(place_ranks(model, store[tier], cfg, mesh), queries, valid)
    assert len(scans) == model_n
    want_d, want_i, want_hits = _dense_merge(scans, NQ, K)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    assert int(hits) == want_hits
    if sigma == -1.0:
        assert want_hits > 0                            # the replicas are met
    if q_cap_factor == 0.5 and sigma == -1.0:
        assert int(overflow) > 0


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("width", [40, 400])
def test_plain_dedup_count_equals_numpy(width, k):
    """``dedup_topk_ref``'s count against a NumPy count on pools with
    replicas, a row all padding, a row with k above its valid count and a
    row whose every distance is non-finite; the answers are those it gives
    without counting."""
    d, ids = (torch.from_numpy(a) for a in rt.dup_pool(width, seed=width + k))
    dups = torch.full((d.shape[0],), -7, dtype=torch.int64)
    got = kops.dedup_topk(d, ids, k, impl="ref", dups=dups)
    want = rt.dup_count_np(ids.numpy())
    np.testing.assert_array_equal(dups.numpy(), want)
    assert want[-1] == 0 and want[-3] > 0 and want[:-3].min() > 0
    for a, b in zip(got, tref.dedup_topk_ref(d, ids, k)):
        assert torch.equal(a, b)
    # the kernel's wrapper takes the plain version for CPU tensors, count too
    again = torch.zeros_like(dups)
    for a, b in zip(dd_mod.dedup_topk(d, ids, k, dups=again), got):
        assert torch.equal(a, b)
    assert torch.equal(again, dups)
    assert bool((got[1][-3:-2] == -1).all()) and bool((got[1][-1] == -1).all())


def test_plain_dedup_count_runs_on_meta():
    """The dry run's device: the count is written with no host read."""
    d = torch.empty((4, 30), device="meta")
    ids = torch.empty((4, 30), dtype=torch.int32, device="meta")
    dups = torch.empty(4, dtype=torch.int64, device="meta")
    out_d, out_i = kops.dedup_topk(d, ids, 5, dups=dups)
    assert out_d.shape == out_i.shape == (4, 5) and out_d.device.type == "meta"
