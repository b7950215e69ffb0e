"""The quantized tiers' exact rerank (``kernels.ops.rerank_topk_qbuf``, stage 2
of the quantized scan): the port's plain version against the JAX package's
stage 2 arithmetic (``repro.serving.scan``'s rerank after the ADC shortlist,
the same shortlist fed in through its stage-1 op), on
``repro_torch.testing``'s rerank cases. ``test_torch_cuda.py`` holds the
kernel against the plain version on the same cases, on the card.

Tolerance: ``testing.l2_atol``; the two sum the expansion ||q||² − 2q·x +
||x||² in other orders. Ids are equal up to ties at the k-th place, element
for element where the distances are exact (small integers), which holds the
lower shortlist position to an exact tie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import scan as jscan
from repro_torch import testing as rt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rerank_topk as rr_mod


def _jax_stage2(q_pad, qbuf, vecs, ids, shortlist, k, monkeypatch):
    """JAX's stage 2 over ``shortlist``: its quantized kernel path with the
    stage-1 op answering with the shortlist, padded with -1 up to k where it
    is shorter (its top_k takes no more than it is given; a -1 entry scores
    +inf with id -1, as the port's padding)."""
    rk = shortlist.shape[2]
    if rk < k:
        pad = np.full((*shortlist.shape[:2], k - rk), -1, np.int32)
        shortlist = np.concatenate([shortlist, pad], 2)
    monkeypatch.setattr(jscan.kops, "pq_adc_topk_qbuf",
                        lambda *a, **kw: (None, jnp.asarray(shortlist)))
    d, i = jscan._quantized_kernel(jnp.asarray(qbuf), jnp.asarray(q_pad), vecs, jnp.asarray(ids),
                                   k, None, None, shortlist.shape[2], None, None, "ref")
    return np.asarray(d), np.asarray(i)


def _torch_case(case, seed):
    (q_pad, qbuf, vecs, ids, sl), k, dtype, exact = rt.rerank_case(case, seed=seed)
    args = [torch.from_numpy(a) for a in (q_pad, qbuf, vecs, ids, sl)]
    args[2] = args[2].to(getattr(torch, dtype))
    return args, k, dtype, exact


@pytest.mark.parametrize("case", rt.RERANK_CASES)
def test_rerank_plain_matches_jax(case, monkeypatch):
    (q_pad, qbuf, vecs, ids, sl), k, dtype, exact = _torch_case(case, 31)
    td, ti = tops.rerank_topk_qbuf(q_pad, qbuf, vecs, ids, sl, k, impl="ref")
    assert td.shape == ti.shape == (*qbuf.shape, k)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    occ = rt.occupied(q_pad, qbuf)
    assert bool(torch.isinf(td[~occ]).all()) and bool((ti[~occ] == -1).all())
    jv = jnp.asarray(vecs.float().numpy()).astype(jnp.bfloat16 if dtype == "bfloat16"
                                                   else jnp.float32)
    jd, ji = _jax_stage2(q_pad.numpy(), qbuf.numpy(), jv, ids.numpy(), sl.numpy(), k,
                         monkeypatch)
    o = occ.numpy()
    rt.assert_topk_match(td[occ], ti[occ], jd[o], ji[o],
                         rt.qbuf_atol(q_pad, qbuf, vecs.float(), ids), exact_ids=exact,
                         what=case)
    # bucket 0 holds no valid id: every occupied slot there is inf / -1
    assert bool(torch.isinf(td[0]).all()) and bool((ti[0] == -1).all())


@pytest.mark.parametrize("case", ["holes+padding", "rk<k", "bf16 store, odd d"])
def test_rerank_wrapper_takes_the_plain_version_off_the_card(case):
    """Tensors that are not on the card go to the plain version, with its
    bits, and launch nothing; ``impl="cuda"`` through the op does the
    same."""
    args, k, _, _ = _torch_case(case, 32)
    before = rr_mod.launches
    want = tref.rerank_topk_qbuf_ref(*args, k)
    for got in (rr_mod.rerank_topk_qbuf(*args, k), tops.rerank_topk_qbuf(*args, k, impl="cuda")):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert rr_mod.launches == before
