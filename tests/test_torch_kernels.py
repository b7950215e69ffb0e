"""The port's kernel modules against the JAX reference: the plain PyTorch
versions of ``l2_topk_qbuf``, ``pq_adc_topk_qbuf`` and ``dedup_topk`` vs
``repro.kernels.ops`` with ``impl="ref"`` (and vs the numpy ``dedup_topk_np``)
on the same numpy inputs.
The edge cases and the comparison, with its tolerances, are
``repro_torch.testing``'s; ``test_torch_cuda.py`` holds the CUDA kernels
against the same plain versions on the card with the same cases.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.dedup_topk import dedup_topk_np as jax_dedup_topk_np
from repro_torch import testing as rt
from repro_torch.kernels import dedup_topk as dd_mod
from repro_torch.kernels import l2_topk as l2_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pq_adc as adc_mod
from repro_torch.kernels import ref as tref


@pytest.mark.parametrize("case", rt.L2_CASES)
def test_l2_topk_qbuf_plain_matches_jax_ref(case):
    (q_pad, qbuf, cands, ids), k, dtype, exact = rt.l2_case(case, seed=1)
    jd, ji = jops.l2_topk_qbuf(jnp.asarray(q_pad, dtype), jnp.asarray(qbuf),
                               jnp.asarray(cands, dtype), jnp.asarray(ids), k, impl="ref")
    tdt = getattr(torch, dtype)
    td, ti = tops.l2_topk_qbuf(torch.from_numpy(q_pad).to(tdt), torch.from_numpy(qbuf),
                               torch.from_numpy(cands).to(tdt), torch.from_numpy(ids), k,
                               impl="ref")
    assert td.shape == ti.shape == (qbuf.shape[0], qbuf.shape[1], k)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    occ = rt.occupied(q_pad, qbuf)
    jd, ji = np.asarray(jd, np.float32), np.asarray(ji)
    rt.assert_topk_match(td.numpy()[occ], ti.numpy()[occ], jd[occ], ji[occ],
                         rt.qbuf_atol(q_pad, qbuf, cands, ids), exact_ids=exact)
    # the sentinel rows are garbage by contract, but finite garbage on both sides
    np.testing.assert_allclose(td.numpy()[~occ], jd[~occ], rtol=rt.RTOL)


def test_l2_topk_flat_and_batched_plain_match_jax_ref():
    (q_pad, qbuf, cands, ids), _, _, _ = rt.l2_case("holes+padding", seed=2)
    q = q_pad[:8]  # bucket 0 holds no valid candidate: take bucket 1
    jd, ji = jops.l2_topk(jnp.asarray(q), jnp.asarray(cands[1]), jnp.asarray(ids[1]), 5,
                          impl="ref")
    td, ti = tref.l2_topk_ref(torch.from_numpy(q), torch.from_numpy(cands[1]),
                              torch.from_numpy(ids[1]), 5)
    rt.assert_topk_match(td, ti, jd, ji, 1e-3)
    qb = np.stack([q, q[::-1]] * 2)
    jd, ji = jops.l2_topk_batched(jnp.asarray(qb), jnp.asarray(cands), jnp.asarray(ids), 5,
                                  impl="ref")
    td, ti = tref.l2_topk_batched_ref(torch.from_numpy(qb), torch.from_numpy(cands),
                                      torch.from_numpy(ids), 5)
    rt.assert_topk_match(td, ti, jd, ji, 1e-3)


@pytest.mark.parametrize("case", rt.DEDUP_CASES)
def test_dedup_topk_plain_matches_jax_ref_and_numpy(case):
    (d, ids), k = rt.dedup_case(case, seed=3)
    jd, ji = jops.dedup_topk(jnp.asarray(d), jnp.asarray(ids), k, impl="ref")
    td, ti = tops.dedup_topk(torch.from_numpy(d), torch.from_numpy(ids), k, impl="ref")
    nd, ni = tref.dedup_topk_np(d, ids, k)
    jnd, jni = jax_dedup_topk_np(d, ids, k)
    for od, oi in ((jd, ji), (nd, ni), (jnd, jni)):
        np.testing.assert_array_equal(td.numpy(), np.asarray(od))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(oi))
    for r in range(len(d)):  # each id once, ordered by (dist, id)
        row = [(float(x), int(i)) for x, i in zip(td[r], ti[r]) if i >= 0]
        assert row == sorted(row) and len({i for _, i in row}) == len(row)


def _np_or_none(a, f):
    return None if a is None else f(a)


@pytest.mark.parametrize("case", rt.ADC_CASES)
def test_pq_adc_topk_qbuf_plain_matches_jax_ref(case):
    """The JAX oracle adds cand_off before q_off, the port q_off first (the
    kernel's order): distances agree under ``adc_atol``, not bit for bit."""
    (lut_pad, qbuf, codes, ids, coff, qoff), k, exact = rt.adc_case(case, seed=1)
    jd, ji = jops.pq_adc_topk_qbuf(jnp.asarray(lut_pad), jnp.asarray(qbuf), jnp.asarray(codes),
                                   jnp.asarray(ids), k, cand_off=_np_or_none(coff, jnp.asarray),
                                   q_off=_np_or_none(qoff, jnp.asarray), impl="ref")
    td, ti = tops.pq_adc_topk_qbuf(
        torch.from_numpy(lut_pad), torch.from_numpy(qbuf), torch.from_numpy(codes),
        torch.from_numpy(ids), k, cand_off=_np_or_none(coff, torch.from_numpy),
        q_off=_np_or_none(qoff, torch.from_numpy), impl="ref")
    assert td.shape == ti.shape == (qbuf.shape[0], qbuf.shape[1], k)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    occ = rt.occupied(lut_pad, qbuf)
    jd, ji = np.asarray(jd, np.float32), np.asarray(ji)
    atol = rt.adc_atol(lut_pad, coff, qoff)
    rt.assert_topk_match(td.numpy()[occ], ti.numpy()[occ], jd[occ], ji[occ], atol,
                         exact_ids=exact)
    # the empty slots scan the zero LUT row: garbage by contract, the same on both sides
    np.testing.assert_allclose(td.numpy()[~occ], jd[~occ], rtol=rt.RTOL, atol=atol)


def test_pq_adc_flat_and_batched_plain_match_jax_ref():
    (lut_pad, qbuf, codes, ids, coff, qoff), _, _ = rt.adc_case("residual offsets", seed=2)
    lut = lut_pad[:8]  # bucket 0 holds no valid candidate: take bucket 1
    t, j = torch.from_numpy, jnp.asarray
    np.testing.assert_allclose(tref.pq_adc_ref(t(lut), t(codes[1])).numpy(),
                               np.asarray(jops.pq_adc(j(lut), j(codes[1]), impl="ref")),
                               rtol=rt.RTOL, atol=rt.adc_atol(lut))
    qo = np.arange(8, dtype=np.float32)
    jd, ji = jops.pq_adc_topk(j(lut), j(codes[1]), j(ids[1]), 5, cand_off=j(coff[1]),
                              q_off=j(qo), impl="ref")
    td, ti = tref.pq_adc_topk_ref(t(lut), t(codes[1]), t(ids[1]), 5, cand_off=t(coff[1]),
                                  q_off=t(qo))
    rt.assert_topk_match(td, ti, jd, ji, rt.adc_atol(lut, coff, qo))
    lb = np.stack([lut, lut[::-1]] * 2)
    qb = np.stack([qo] * 4)
    jd, ji = jops.pq_adc_topk_batched(j(lb), j(codes), j(ids), 5, cand_off=j(coff),
                                      q_off=j(qb), impl="ref")
    td, ti = tref.pq_adc_topk_batched_ref(t(lb), t(codes), t(ids), 5, cand_off=t(coff),
                                          q_off=t(qb))
    rt.assert_topk_match(td, ti, jd, ji, rt.adc_atol(lut, coff, qo))
    # without offsets the plain versions add nothing
    td, ti = tref.pq_adc_topk_batched_ref(t(lb), t(codes), t(ids), 5)
    jd, ji = jops.pq_adc_topk_batched(j(lb), j(codes), j(ids), 5, impl="ref")
    rt.assert_topk_match(td, ti, jd, ji, rt.adc_atol(lut))


def test_pq_adc_plain_chunks_give_the_whole_answer(monkeypatch):
    """The plain version goes bucket chunk by bucket chunk; one bucket per
    chunk gives the same answer as all at once."""
    (lut_pad, qbuf, codes, ids, coff, qoff), k, _ = rt.adc_case("uint16 codes", seed=3)
    args = [torch.from_numpy(a) for a in (lut_pad, qbuf, codes, ids)]
    offs = dict(cand_off=torch.from_numpy(coff), q_off=torch.from_numpy(qoff))
    whole = tref.pq_adc_topk_qbuf_ref(*args, k, **offs)
    monkeypatch.setattr(tref, "_ADC_CHUNK", 1)
    for got, want in zip(tref.pq_adc_topk_qbuf_ref(*args, k, **offs), whole):
        assert torch.equal(got, want)


def test_wrappers_take_plain_version_for_cpu_tensors():
    """The kernel wrappers run the plain version for CPU tensors (and only
    because the tensors lie on the CPU), without counting a launch."""
    l2_before, dd_before = l2_mod.launches, dd_mod.launches
    q_pad, qbuf, cands, ids = (torch.from_numpy(a) for a in rt.l2_case("holes+padding", seed=4)[0])
    for got, want in zip(l2_mod.l2_topk_qbuf(q_pad, qbuf, cands, ids, 5),
                         tref.l2_topk_qbuf_ref(q_pad, qbuf, cands, ids, 5)):
        assert torch.equal(got, want)
    d, i = (torch.from_numpy(a) for a in rt.dedup_case("duplicates+padding+non-finite", seed=5)[0])
    for got, want in zip(dd_mod.dedup_topk(d, i, 8), tref.dedup_topk_ref(d, i, 8)):
        assert torch.equal(got, want)
    for got, want in zip(tops.dedup_topk(d, i, 8, impl="cuda"), tref.dedup_topk_ref(d, i, 8)):
        assert torch.equal(got, want)
    adc_before = adc_mod.launches
    (lut_pad, qbuf, codes, ids, coff, qoff), k, _ = rt.adc_case("residual offsets", seed=6)
    args = [torch.from_numpy(a) for a in (lut_pad, qbuf, codes, ids)]
    offs = dict(cand_off=torch.from_numpy(coff), q_off=torch.from_numpy(qoff))
    for got, want in zip(adc_mod.pq_adc_topk_qbuf(*args, k, **offs),
                         tref.pq_adc_topk_qbuf_ref(*args, k, **offs)):
        assert torch.equal(got, want)
    for got, want in zip(tops.pq_adc_topk_qbuf(*args, k, impl="cuda", **offs),
                         tref.pq_adc_topk_qbuf_ref(*args, k, **offs)):
        assert torch.equal(got, want)
    assert (l2_mod.launches, dd_mod.launches, adc_mod.launches) == (l2_before, dd_before,
                                                                    adc_before)


def test_impl_resolution():
    assert tops.default_impl("cpu") == "ref"
    assert tops.default_impl("cuda") == "cuda"
    assert tops.resolve_impl(None, "cpu") == tops.resolve_impl("auto", "cpu") == "ref"
    with pytest.raises(ValueError, match="unknown impl"):
        tops.resolve_impl("pallas", "cpu")
