"""The port's full, flat and batched ADC (``pq_adc``, ``pq_adc_topk``,
``pq_adc_topk_batched``) against the JAX reference: the port's plain versions
(what its kernel wrappers run for CPU tensors) vs ``repro.kernels.ops`` with
``impl="ref"`` and with ``impl="interpret"`` (the JAX kernels themselves,
which run clean for these three), on ``repro_torch.testing``'s ADC cases
expanded through the dispatch buffer: every slot's LUT row is a query row,
the flat forms take one bucket (bucket 0 has no valid candidate).

Tolerance: ``testing.adc_atol``. The JAX kernels add the LUT terms in the
order of a one-hot contraction and their oracles add cand_off before q_off;
the port adds over m in order, then q_off, then cand_off. Ids are equal up to
ties at the k-th place, element for element where the distances are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import testing as rt
from repro_torch.core import pq as tpq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pq_adc as adc_mod
from repro_torch.kernels import ref as tref

IMPLS = ["ref", "interpret"]
# The JAX top-k kernels keep the id beside a -inf distance, where their
# oracles and the port write -1: that case is held against impl="ref" alone.
TOPK_CASES = [(case, impl) for case in rt.ADC_CASES for impl in IMPLS
              if (case, impl) != ("non-finite distances", "interpret")]


def _expanded(case, seed):
    """The case expanded through qbuf: (lut [B, S, m, ks], codes, ids,
    cand_off, q_off) as numpy, k, exact."""
    (lut_pad, qbuf, *rest), k, exact = rt.adc_case(case, seed=seed)
    return (lut_pad[qbuf], *rest), k, exact


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _pick(a, b):
    return None if a is None else a[b]


@pytest.mark.parametrize("jax_impl", IMPLS)
@pytest.mark.parametrize("case", rt.ADC_CASES)
def test_pq_adc_plain_matches_jax(case, jax_impl):
    (lut, codes, _, _, _), _, _ = _expanded(case, 20)
    for b in (0, 1):
        want = np.asarray(jops.pq_adc(jnp.asarray(lut[b]), jnp.asarray(codes[b]), impl=jax_impl))
        got = tops.pq_adc(_t(lut[b]), _t(codes[b]), impl="ref")
        assert got.shape == (lut.shape[1], codes.shape[1]) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=rt.RTOL, atol=rt.adc_atol(lut[b]))


@pytest.mark.parametrize("case,jax_impl", TOPK_CASES)
def test_pq_adc_topk_plain_matches_jax(case, jax_impl):
    (lut, codes, ids, coff, qoff), k, exact = _expanded(case, 21)
    for b in (0, 1):  # bucket 0 holds no valid candidate
        args = (lut[b], codes[b], ids[b])
        jd, ji = jops.pq_adc_topk(*map(jnp.asarray, args), k, cand_off=_j(_pick(coff, b)),
                                  q_off=_j(_pick(qoff, b)), impl=jax_impl)
        td, ti = tops.pq_adc_topk(*map(_t, args), k, cand_off=_t(_pick(coff, b)),
                                  q_off=_t(_pick(qoff, b)), impl="ref")
        assert td.shape == ti.shape == (lut.shape[1], k)
        assert td.dtype == torch.float32 and ti.dtype == torch.int32
        rt.assert_topk_match(td, ti, jd, ji, rt.adc_atol(lut[b], _pick(coff, b), _pick(qoff, b)),
                             exact_ids=exact, what=f"{case}, bucket {b}")
        if b == 0:
            assert bool(torch.isinf(td).all()) and bool((ti == -1).all())


@pytest.mark.parametrize("case,jax_impl", TOPK_CASES)
def test_pq_adc_topk_batched_plain_matches_jax(case, jax_impl):
    (lut, codes, ids, coff, qoff), k, exact = _expanded(case, 22)
    jd, ji = jops.pq_adc_topk_batched(jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(ids), k,
                                      cand_off=_j(coff), q_off=_j(qoff), impl=jax_impl)
    td, ti = tops.pq_adc_topk_batched(_t(lut), _t(codes), _t(ids), k, cand_off=_t(coff),
                                      q_off=_t(qoff), impl="ref")
    assert td.shape == ti.shape == (*lut.shape[:2], k)
    rt.assert_topk_match(td, ti, jd, ji, rt.adc_atol(lut, coff, qoff), exact_ids=exact,
                         what=case)


@pytest.mark.parametrize("case", ["residual offsets", "uint16 codes", "exact ties"])
def test_batched_equals_qbuf_plain_on_every_slot(case):
    """The expansion of qbuf and the dispatch-buffer scan are one function:
    the batched plain version gives the qbuf plain version's bits on every
    slot (on the card the qbuf kernel flushes the empty ones unscanned)."""
    arrays, k, _ = rt.adc_case(case, seed=23)
    lut_pad, qbuf, codes, ids, coff, qoff = map(_t, arrays)
    want = tops.pq_adc_topk_qbuf(lut_pad, qbuf, codes, ids, k, cand_off=coff, q_off=qoff,
                                 impl="ref")
    got = tops.pq_adc_topk_batched(lut_pad[qbuf.long()], codes, ids, k, cand_off=coff,
                                   q_off=qoff, impl="ref")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_adc_distances_equals_ops_pq_adc():
    """``core/pq.adc_distances`` is the plain full matrix: bit for bit."""
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.normal(size=(600, 16)).astype(np.float32))
    book = tpq.train_pq(x, m=4, ks=16, n_iters=3, generator=torch.Generator().manual_seed(0))
    codes = tpq.encode(book, x)
    q = x[:9] + 0.1
    assert torch.equal(tpq.adc_distances(book, q, codes),
                       tops.pq_adc(tpq.adc_lut(book, q), codes))


def test_adc_wrappers_take_plain_version_for_cpu_tensors():
    """The three wrappers run their plain versions for CPU tensors, through
    ops with impl="cuda" too, without counting a launch."""
    before = (adc_mod.full_launches, adc_mod.flat_launches, adc_mod.batched_launches)
    (lut, codes, ids, coff, qoff), k, _ = _expanded("residual offsets", 25)
    lut, codes, ids, coff, qoff = map(_t, (lut, codes, ids, coff, qoff))
    want = tref.pq_adc_ref(lut[1], codes[1])
    assert torch.equal(adc_mod.pq_adc(lut[1], codes[1]), want)
    assert torch.equal(tops.pq_adc(lut[1], codes[1], impl="cuda"), want)
    flat = (lut[1], codes[1], ids[1], k)
    offs = dict(cand_off=coff[1], q_off=qoff[1])
    want = tref.pq_adc_topk_ref(*flat, **offs)
    for got in (adc_mod.pq_adc_topk(*flat, **offs), tops.pq_adc_topk(*flat, impl="cuda", **offs)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    offs = dict(cand_off=coff, q_off=qoff)
    want = tref.pq_adc_topk_batched_ref(lut, codes, ids, k, **offs)
    for got in (adc_mod.pq_adc_topk_batched(lut, codes, ids, k, **offs),
                tops.pq_adc_topk_batched(lut, codes, ids, k, impl="cuda", **offs)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (adc_mod.full_launches, adc_mod.flat_launches, adc_mod.batched_launches) == before


def test_plain_flat_topk_chunks_over_query_rows(monkeypatch):
    """The plain flat top-k is one bucket; when its rows × candidates exceed
    a chunk it goes in chunks of query rows, with the same answer."""
    (lut, codes, ids, coff, qoff), k, _ = _expanded("more slots than one group", 26)
    args = (_t(lut[1]), _t(codes[1]), _t(ids[1]), k)
    offs = dict(cand_off=_t(coff[1]), q_off=_t(qoff[1]))
    whole = tref.pq_adc_topk_ref(*args, **offs)
    monkeypatch.setattr(tref, "_ADC_CHUNK", 3 * max(codes.shape[1], lut[0, 0].size))
    for got, want in zip(tref.pq_adc_topk_ref(*args, **offs), whole):
        assert torch.equal(got, want)


def test_plain_topk_equals_stable_topk_of_the_matrix():
    """Without offsets and padding the fused top-k is a stable top-k of the
    full matrix (lowest position first on a tie)."""
    (lut, codes, _, _, _), k, _ = _expanded("exact ties across ranges", 27)
    lut, codes = _t(lut[1]), _t(codes[1])
    ids = torch.arange(codes.shape[0], dtype=torch.int32)
    d, i = tops.pq_adc_topk(lut, codes, ids, k, impl="ref")
    sd, si = tref.smallest_k(tops.pq_adc(lut, codes, impl="ref"), k)
    assert torch.equal(d, sd) and torch.equal(i, si.to(torch.int32))
