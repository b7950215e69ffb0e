"""The port's kernel modules against the JAX reference: the plain PyTorch
versions of ``l2_topk_qbuf``, ``pq_adc_topk_qbuf`` and ``dedup_topk`` vs
``repro.kernels.ops`` with ``impl="ref"`` (and vs the numpy ``dedup_topk_np``)
on the same numpy inputs; those of ``kmeans_assign``, ``l2_topk`` and
``l2_topk_batched`` vs both ``impl="ref"`` and the JAX kernels themselves
(``impl="interpret"``, which runs clean for these three).
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
from repro_torch.kernels import kmeans_assign as km_mod
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


@pytest.mark.parametrize("jax_impl", ["ref", "interpret"])
@pytest.mark.parametrize("case", rt.KMEANS_CASES)
def test_kmeans_assign_plain_matches_jax(case, jax_impl):
    (x, c), dtype, exact = rt.kmeans_case(case, seed=1)
    ja, jd = jops.kmeans_assign(jnp.asarray(x, dtype), jnp.asarray(c, dtype), impl=jax_impl)
    tdt = getattr(torch, dtype)
    xt, ct = torch.from_numpy(x).to(tdt), torch.from_numpy(c).to(tdt)
    ta, td = tops.kmeans_assign(xt, ct, impl="ref")
    assert ta.shape == td.shape == (len(x),)
    assert ta.dtype == torch.int32 and td.dtype == torch.float32
    rt.assert_assign_match(ta, td, ja, jd, xt, ct, exact=exact)


def _tf32(a, *, rna: bool):
    """The TF32 value of float32 ``a``: rounded to nearest with ties away
    (``cvt.rna.tf32.f32``) or truncated, as the tensor cores read a plain f32
    operand."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    if rna:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("width", ["small", "main"])
@pytest.mark.parametrize("case", ["large common offset", "ragged N and B"])
def test_one_tf32_product_fails_the_rule_and_the_split_passes(case, width):
    """Why the card's kernel takes three TF32 products: with TF32 operands and
    exact (float64) sums, one product x_hi.c_hi misses the parity rule
    (``assert_assign_match``) on these cases, and the split x_hi.c_lo +
    x_lo.c_hi + x_hi.c_hi (hi rounded to nearest, lo = v - hi truncated on
    read) meets it."""
    (x, c), _, _ = rt.kmeans_case(case, width=width, seed=1)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    pa, pd = tref.kmeans_assign_ref(xt, ct)
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    norms = (x64 * x64).sum(1)[:, None], (c64 * c64).sum(1)[None, :]

    def assignment(prod):
        d2 = torch.from_numpy((norms[0] - 2.0 * prod + norms[1]).astype(np.float32))
        return torch.argmin(d2, 1).int(), d2.min(1).values

    xh, ch = _tf32(x, rna=True), _tf32(c, rna=True)
    xl, cl = _tf32(x - xh, rna=False), _tf32(c - ch, rna=False)
    xh, ch, xl, cl = (a.astype(np.float64) for a in (xh, ch, xl, cl))
    with pytest.raises(AssertionError):
        rt.assert_assign_match(*assignment(xh @ ch.T), pa, pd, xt, ct)
    rt.assert_assign_match(*assignment(xh @ cl.T + xl @ ch.T + xh @ ch.T), pa, pd, xt, ct)


def _scan_case(case, seed):
    (q, cands, ids), k, dtype, exact = rt.l2_scan_case(case, seed=seed)
    tdt = getattr(torch, dtype)
    jax_in = (jnp.asarray(q, dtype), jnp.asarray(cands, dtype), jnp.asarray(ids))
    torch_in = (torch.from_numpy(q).to(tdt), torch.from_numpy(cands).to(tdt),
                torch.from_numpy(ids))
    return jax_in, torch_in, k, exact


@pytest.mark.parametrize("jax_impl", ["ref", "interpret"])
@pytest.mark.parametrize("case", rt.L2_SCAN_CASES)
def test_l2_topk_plain_matches_jax(case, jax_impl):
    (jq, jc, ji_), (q, cands, ids), k, exact = _scan_case(case, 1)
    jd, ji = jops.l2_topk(jq[0], jc[0], ji_[0], k, impl=jax_impl)
    td, ti = tops.l2_topk(q[0], cands[0], ids[0], k, impl="ref")
    assert td.shape == ti.shape == (q.shape[1], k)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    rt.assert_topk_match(td, ti, jd, ji, rt.l2_atol(q[0], cands[0], ids[0]), exact_ids=exact)


@pytest.mark.parametrize("jax_impl", ["ref", "interpret"])
@pytest.mark.parametrize("case", rt.L2_SCAN_CASES)
def test_l2_topk_batched_plain_matches_jax(case, jax_impl):
    (jq, jc, ji_), (q, cands, ids), k, exact = _scan_case(case, 2)
    jd, ji = jops.l2_topk_batched(jq, jc, ji_, k, impl=jax_impl)
    td, ti = tops.l2_topk_batched(q, cands, ids, k, impl="ref")
    assert td.shape == ti.shape == (*q.shape[:2], k)
    rt.assert_topk_match(td, ti, jd, ji, rt.l2_atol(q.reshape(-1, q.shape[-1]), cands, ids),
                         exact_ids=exact)


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


def test_scan_and_assign_wrappers_take_plain_version_for_cpu_tensors():
    """The flat, batched and k-means wrappers run their plain versions for CPU
    tensors, through ops with impl="cuda" too, without counting a launch."""
    before = (l2_mod.flat_launches, l2_mod.batched_launches, km_mod.launches)
    q, cands, ids = (torch.from_numpy(a) for a in rt.l2_scan_case("holes+padding", seed=3)[0])
    for got, want in zip((*l2_mod.l2_topk(q[0], cands[0], ids[0], 5),
                          *tops.l2_topk(q[0], cands[0], ids[0], 5, impl="cuda")),
                         2 * tref.l2_topk_ref(q[0], cands[0], ids[0], 5)):
        assert torch.equal(got, want)
    for got, want in zip((*l2_mod.l2_topk_batched(q, cands, ids, 5),
                          *tops.l2_topk_batched(q, cands, ids, 5, impl="cuda")),
                         2 * tref.l2_topk_batched_ref(q, cands, ids, 5)):
        assert torch.equal(got, want)
    x, c = (torch.from_numpy(a) for a in rt.kmeans_case("ragged N and B", seed=4)[0])
    for got, want in zip((*km_mod.kmeans_assign(x, c), *tops.kmeans_assign(x, c, impl="cuda")),
                         2 * tref.kmeans_assign_ref(x, c)):
        assert torch.equal(got, want)
    assert (l2_mod.flat_launches, l2_mod.batched_launches, km_mod.launches) == before


def test_plain_assignment_blocks_give_the_whole_answer(monkeypatch):
    """The plain assignment goes block of rows by block; blocks of 7 rows
    give the answer of one block."""
    x, c = (torch.from_numpy(a) for a in rt.kmeans_case("ragged N and B", seed=5)[0])
    whole = tref.kmeans_assign_ref(x, c)
    monkeypatch.setattr(tref, "_ASSIGN_BLOCK", 7)
    for got, want in zip(tref.kmeans_assign_ref(x, c), whole):
        assert torch.equal(got, want)


def test_impl_resolution():
    assert tops.default_impl("cpu") == "ref"
    assert tops.default_impl("cuda") == "cuda"
    assert tops.resolve_impl(None, "cpu") == tops.resolve_impl("auto", "cpu") == "ref"
    with pytest.raises(ValueError, match="unknown impl"):
        tops.resolve_impl("pallas", "cpu")
