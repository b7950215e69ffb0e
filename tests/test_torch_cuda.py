"""The CUDA kernels against their plain PyTorch versions, on the card. This
file imports no jax, so it runs on a machine with a card and without the JAX
package: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a card (or nvcc) its ``cuda`` tests skip. The edge cases and the
comparison (with its tolerances) are ``repro_torch.testing``'s, which
``test_torch_kernels.py`` and ``chip_smoke.py`` share.
"""
import os
import shutil

import pytest
import torch

from repro_torch import testing as rt
from repro_torch.kernels import dedup_topk as dd_mod
from repro_torch.kernels import l2_topk as l2_mod
from repro_torch.kernels import pq_adc as adc_mod
from repro_torch.kernels import ref as tref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.L2_CASES)
def test_l2_topk_qbuf_kernel_matches_plain(cuda_device, case):
    arrays, k, dtype, exact = rt.l2_case(case, seed=6)
    tdt = getattr(torch, dtype)
    q_pad, qbuf, cands, ids = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    q_pad, cands = q_pad.to(tdt), cands.to(tdt)
    before = l2_mod.launches
    kd, ki = l2_mod.l2_topk_qbuf(q_pad, qbuf, cands, ids, k)
    torch.cuda.synchronize()
    assert l2_mod.launches == before + 1
    pd, pi = tref.l2_topk_qbuf_ref(q_pad, qbuf, cands, ids, k)
    occ = rt.occupied(q_pad, qbuf)
    assert bool(torch.isinf(kd[~occ]).all()) and bool((ki[~occ] == -1).all())
    rt.assert_topk_match(kd[occ], ki[occ], pd[occ], pi[occ],
                         rt.qbuf_atol(q_pad, qbuf, cands, ids), exact_ids=exact)


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.DEDUP_CASES)
def test_dedup_topk_kernel_matches_plain(cuda_device, case):
    arrays, k = rt.dedup_case(case, seed=7)
    d, ids = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    before = dd_mod.launches
    kd, ki = dd_mod.dedup_topk(d, ids, k)
    torch.cuda.synchronize()
    assert dd_mod.launches == before + 1
    pd, pi = tref.dedup_topk_ref(d, ids, k)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def _adc_inputs(case, dev, seed):
    (lut_pad, qbuf, codes, ids, coff, qoff), k, _ = rt.adc_case(case, seed=seed)
    args = [torch.from_numpy(a).to(dev) for a in (lut_pad, qbuf, codes, ids)]
    offs = {name: None if a is None else torch.from_numpy(a).to(dev)
            for name, a in (("cand_off", coff), ("q_off", qoff))}
    return args, offs, k


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.ADC_CASES)
def test_pq_adc_topk_qbuf_kernel_equals_plain(cuda_device, case):
    """The kernel adds in the plain version's order: distances and ids equal."""
    args, offs, k = _adc_inputs(case, cuda_device, 10)
    before = adc_mod.launches
    kd, ki = adc_mod.pq_adc_topk_qbuf(*args, k, **offs)
    torch.cuda.synchronize()
    assert adc_mod.launches == before + 1
    pd, pi = tref.pq_adc_topk_qbuf_ref(*args, k, **offs)
    occ = rt.occupied(args[0], args[1])
    assert bool(torch.isinf(kd[~occ]).all()) and bool((ki[~occ] == -1).all())
    assert torch.equal(kd[occ], pd[occ]) and torch.equal(ki[occ], pi[occ])


@pytest.mark.cuda
def test_pq_adc_wrapper_rejects_what_it_does_not_take(cuda_device):
    (lut_pad, qbuf, codes, ids), offs, k = _adc_inputs("residual offsets", cuda_device, 11)
    with pytest.raises(TypeError):                       # codes widened to int32
        adc_mod.pq_adc_topk_qbuf(lut_pad, qbuf, codes.int(), ids, k, **offs)
    with pytest.raises(TypeError):
        adc_mod.pq_adc_topk_qbuf(lut_pad.double(), qbuf, codes, ids, k)
    with pytest.raises(ValueError):                      # m differs
        adc_mod.pq_adc_topk_qbuf(lut_pad[:, :2], qbuf, codes, ids, k)
    with pytest.raises(ValueError):
        adc_mod.pq_adc_topk_qbuf(lut_pad, qbuf, codes, ids[:, :5], k)
    with pytest.raises(ValueError):
        adc_mod.pq_adc_topk_qbuf(lut_pad, qbuf, codes, ids, k, q_off=offs["q_off"][:, :3])
    # one slot's LUT (64 x 1024 x 4 B = 256 KB) exceeds a block's shared memory
    big = torch.zeros((lut_pad.shape[0], 64, 1024), device=cuda_device)
    before = adc_mod.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        adc_mod.pq_adc_topk_qbuf(big, qbuf, torch.zeros((*ids.shape, 64), dtype=torch.uint16,
                                                        device=cuda_device), ids, k)
    assert adc_mod.launches == before


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(cuda_device):
    arrays, _, _, _ = rt.l2_case("holes+padding", seed=8)
    q_pad, qbuf, cands, ids = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    with pytest.raises(TypeError):
        l2_mod.l2_topk_qbuf(q_pad.double(), qbuf, cands.double(), ids, 5)
    with pytest.raises(TypeError):
        l2_mod.l2_topk_qbuf(q_pad, qbuf.long(), cands, ids, 5)
    with pytest.raises(ValueError):
        l2_mod.l2_topk_qbuf(q_pad[:, :3], qbuf, cands, ids, 5)
    d, i = (torch.from_numpy(a).to(cuda_device) for a in rt.dedup_case("exact ties", seed=9)[0])
    with pytest.raises(TypeError):
        dd_mod.dedup_topk(d.double(), i, 5)
    with pytest.raises(ValueError):
        dd_mod.dedup_topk(d, i[:, :3], 5)
