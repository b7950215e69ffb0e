"""The group autotuner of the dispatch-buffer scans
(``repro_torch.kernels.autotune``) and ``serving/scan.staged_operand_bytes``,
twins of the reference's ``tests/test_scan_prefetch.py`` autotune and
bytes-accounting tests.

On the CPU there is no group G to choose (the kernels' wrappers take their
plain versions), so a sweep times the plain version once a candidate: the
cache, its keys (the store shape and the plane's itemsize) and the records
work as on the card, and the ops wrappers hand the cached group to the
kernel wrappers. On a card (``cuda`` marker; skipped here), every G that
fits gives the calculator's launch's bits, and a G that does not fit is
refused with its reason and never launched.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, ops
from repro_torch.kernels import l2_topk as l2_mod
from repro_torch.kernels import pq_adc as adc_mod
from repro_torch.models.api import sds
from repro_torch.serving import scan

B, S, QR, M, KS = 5, 7, 11, 8, 16


@pytest.fixture(autouse=True)
def empty_cache():
    autotune.clear()
    yield
    autotune.clear()


def test_autotune_cache_key_path():
    t1 = autotune.autotune_pq_adc_qbuf(32, 2, 16, 4, candidates=(1, 2), b_loc=2, q_cap=4,
                                       q_row=6, device="cpu")
    assert t1 in (1, 2)
    recs = autotune.records()
    assert len(recs) == 1 and recs[0]["cached"] is False
    assert set(recs[0]["timings_s"]) == {"1", "2"}
    assert recs[0]["same_bits"] == {"1": True, "2": True} and recs[0]["refused"] == {}
    # same store shape → cache hit, no re-sweep, recorded as cached
    t2 = autotune.autotune_pq_adc_qbuf(32, 2, 16, 4, candidates=(1, 2), b_loc=2, q_cap=4,
                                       q_row=6, device="cpu")
    assert t2 == t1
    recs = autotune.records()
    assert len(recs) == 2 and recs[1]["cached"] is True
    # the ops wrapper resolves group=None through the same cache (uint8 codes)
    assert autotune.lookup(autotune.pq_adc_key(32, 2, 16, 4)) == t1
    assert autotune.lookup(autotune.pq_adc_key(32, 2, 16, 4, 1)) == t1
    # an unseen shape, or another itemsize, is the occupancy calculator's choice
    assert autotune.lookup(autotune.pq_adc_key(999, 2, 16, 4)) is None
    assert autotune.lookup(autotune.pq_adc_key(32, 2, 16, 4, 2)) is None
    assert autotune.lookup(autotune.l2_key(999, 16, 4)) is None


def test_autotune_l2_sweep_records():
    t = autotune.autotune_l2_qbuf(32, 8, 4, candidates=(16, 32), b_loc=2, q_cap=4, q_row=6,
                                  device="cpu")
    assert t in (16, 32)
    assert autotune.lookup(autotune.l2_key(32, 8, 4)) == t
    assert autotune.lookup(autotune.l2_key(32, 8, 4, 2)) is None    # a bf16 plane's own key
    t16 = autotune.autotune_l2_qbuf(32, 8, 4, dtype=torch.bfloat16, candidates=(16,),
                                    b_loc=2, q_cap=4, q_row=6, device="cpu")
    assert t16 == 16 and autotune.lookup(autotune.l2_key(32, 8, 4, 2)) == 16
    assert [r["key"] for r in autotune.records()] == [list(autotune.l2_key(32, 8, 4)),
                                                      list(autotune.l2_key(32, 8, 4, 2))]


def test_ops_wrappers_pass_the_cached_group(monkeypatch):
    """``impl="cuda"`` hands the kernel wrappers the cached group (0, the
    calculator's, for a shape no sweep has seen); the answer is the plain
    version's either way on the CPU."""
    seen = []

    def spy(fn):
        def wrapped(*a, group, **kw):
            seen.append(group)
            return fn(*a, group=group, **kw)
        return wrapped

    monkeypatch.setattr(l2_mod, "l2_topk_qbuf", spy(l2_mod.l2_topk_qbuf))
    monkeypatch.setattr(adc_mod, "pq_adc_topk_qbuf", spy(adc_mod.pq_adc_topk_qbuf))
    g = torch.Generator().manual_seed(0)
    q_pad = torch.randn((QR + 1, 16), generator=g)
    qbuf = torch.randint(0, QR + 1, (B, S), generator=g, dtype=torch.int32)
    cands = torch.randn((B, 40, 16), generator=g)
    ids = torch.arange(B * 40, dtype=torch.int32).reshape(B, 40)
    want = ops.l2_topk_qbuf(q_pad, qbuf, cands, ids, 5, impl="ref")
    got = ops.l2_topk_qbuf(q_pad, qbuf, cands, ids, 5, impl="cuda")
    autotune._CACHE[autotune.l2_key(40, 16, 5)] = 32
    again = ops.l2_topk_qbuf(q_pad, qbuf, cands, ids, 5, impl="cuda")
    assert all(torch.equal(a, b) for a, b in zip(want + want, got + again))
    lut = torch.randn((QR + 1, M, KS), generator=g)
    codes = torch.randint(0, KS, (B, 40, M), generator=g).to(torch.uint8)
    ops.pq_adc_topk_qbuf(lut, qbuf, codes, ids, 5, impl="cuda")
    autotune._CACHE[autotune.pq_adc_key(40, M, KS, 5)] = 3
    ops.pq_adc_topk_qbuf(lut, qbuf, codes, ids, 5, impl="cuda")
    assert seen == [0, 32, 0, 3]


def test_staged_operand_bytes_independent_of_slots():
    """Compact staging is flat in the dispatch fan-out, while a per-slot
    expansion of the plane grows with every slot; tensors and meta tensors
    alike."""
    lut_pad = sds((QR + 1, M, KS))
    small = scan.staged_operand_bytes(sds((B, 4), torch.int32), lut_pad)
    big = scan.staged_operand_bytes(torch.zeros((B, 64), dtype=torch.int32), lut_pad)
    row = M * KS * 4
    assert small["expanded_bytes"] == B * 4 * row
    assert big["expanded_bytes"] == B * 64 * row
    assert small["compact_bytes"] == (QR + 1) * row + B * 4 * 4
    assert big["compact_bytes"] - small["compact_bytes"] == B * 60 * 4
    assert big["compact_bytes"] < big["expanded_bytes"]
    bf16 = scan.staged_operand_bytes(sds((B, 4), torch.int32),
                                     sds((QR + 1, 128), torch.bfloat16))
    assert bf16 == {"compact_bytes": (QR + 1) * 256 + B * 16, "expanded_bytes": B * 4 * 256}


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_l2_group_gives_the_default_bits(cuda_device, dtype):
    autotune.autotune_l2_qbuf(3000, 128, 100, dtype=dtype, b_loc=64, q_cap=96, q_row=500,
                              device=cuda_device)
    rec = autotune.records()[-1]
    assert rec["refused"] == {} and rec["same_bits"] == {"16": True, "32": True}
    # the first width where a block of 32 rows needs more shared memory than
    # one may have and a block of 16 does not: 32 is refused with its
    # reason, never launched
    d = next(d for d in range(256, 4097, 128)
             if l2_mod.group_plan(d, 100, 4, 16, cuda_device)["fits"]
             and not l2_mod.group_plan(d, 100, 4, 32, cuda_device)["fits"])
    assert autotune.autotune_l2_qbuf(64, d, 100, b_loc=2, q_cap=4, q_row=6,
                                     device=cuda_device) == 16
    rec = autotune.records()[-1]
    assert "shared memory" in rec["refused"]["32"] and rec["same_bits"] == {"16": True}


@pytest.mark.cuda
def test_every_adc_group_gives_the_default_bits(cuda_device):
    autotune.autotune_pq_adc_qbuf(3000, 16, 256, 400, b_loc=64, q_cap=96, q_row=500,
                                  device=cuda_device)
    rec = autotune.records()[-1]
    assert all(rec["same_bits"].values()) and rec["same_bits"]
    assert set(rec["same_bits"]) | set(rec["refused"]) == {str(g) for g in autotune.ADC_GROUPS}
    for g, reason in rec["refused"].items():
        assert "shared memory" in reason and not adc_mod.group_plan(16, 256, 400, 1, int(g),
                                                                    cuda_device)["fits"]
    assert np.isfinite(list(rec["timings_s"].values())).all()
