"""Each kernel's count of work against a count by hand, the roofline share,
and the trace reduction's arithmetic."""
from __future__ import annotations

import importlib.util
import pathlib

import pytest
import torch

from lirabench import capture, peaks
from lirabench.capture import Reduced

LAYERS = pathlib.Path(__file__).resolve().parents[1] / "layers"


def _layer(name):
    spec = importlib.util.spec_from_file_location(f"t_{name}", LAYERS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_l2_work_by_hand():
    mod = _layer("l2_topk_qbuf_roofline")
    # 3 partitions: 2, 0 and 1 dispatched queries over 5, 7 and 4 live rows
    occ = torch.tensor([2.0, 0.0, 1.0], dtype=torch.float64)
    live = torch.tensor([5.0, 7.0, 4.0], dtype=torch.float64)
    nbytes, flops = mod.work(occ, live, d=8, itemsize=4, k=3, rows=2)
    # rows read: partitions 0 and 2 only, (8·4 + 4) bytes each; 2 queries of
    # 8 floats; 3 dispatched pairs write 3 (dist, id) pairs of 8 bytes
    assert float(nbytes) == (5 + 4) * 36 + 2 * 32 + 3 * 3 * 8
    assert float(flops) == (2 * 5 + 1 * 4) * 2 * 8


def test_l2_hook_counts_occupied_slots_and_live_rows():
    mod = _layer("l2_topk_qbuf_roofline")
    q_pad = torch.zeros((3, 8))                      # 2 queries + the sentinel row
    qbuf = torch.tensor([[0, 1, 2], [2, 2, 2], [1, 2, 2]], dtype=torch.int32)
    cands = torch.zeros((3, 6, 8))
    ids = torch.tensor([[0, 1, 2, 3, 4, -1], [5, 6, 7, 8, 9, 10], [11, 12, 13, 14, -1, -1]])
    cache = {}
    rec = mod.hook(cache, q_pad, qbuf, cands, ids, 3, impl="cuda")
    assert rec["occ"].tolist() == [2.0, 0.0, 1.0]
    assert rec["live"].tolist() == [5.0, 6.0, 4.0]
    assert rec["rows"] == 2 and rec["d"] == 8 and rec["itemsize"] == 4 and rec["k"] == 3
    assert len(cache) == 1


def test_adc_work_by_hand():
    mod = _layer("pq_adc_topk_qbuf_roofline")
    occ = torch.tensor([1.0, 3.0], dtype=torch.float64)
    live = torch.tensor([10.0, 2.0], dtype=torch.float64)
    nbytes, flops = mod.work(occ, live, m=4, ks=16, itemsize=1, k=5, rows=3, cand_off=True,
                             q_off=True)
    # live rows: 4 code bytes + a 4-byte slot id + a 4-byte cross term; 3 LUTs
    # of 4·16 floats; 4 dispatched pairs: a 4-byte offset in, 5 (dist, slot) out
    assert float(nbytes) == 12 * 12 + 3 * 64 * 4 + 4 * (4 + 5 * 8)
    assert float(flops) == (1 * 10 + 3 * 2) * (4 - 1 + 2)
    _, flops_plain = mod.work(occ, live, m=4, ks=16, itemsize=1, k=5, rows=3, cand_off=False,
                              q_off=False)
    assert float(flops_plain) == 16 * 3


def test_dedup_work_by_hand():
    mod = _layer("dedup_topk_roofline")
    assert mod.work(rows=4, pool=300, k=10) == (4 * 300 * 8 + 4 * 10 * 8, 0)
    rec = mod.hook({}, torch.zeros((4, 300)), torch.zeros((4, 300), dtype=torch.int32), 10)
    assert rec == {"rows": 4, "pool": 300, "k": 10}


def test_roofline_share():
    # 3.35 GB at 3.35 TB/s is 1 ms: at 2 ms the share is 50%
    assert peaks.roofline_share(3.35e9, 0, 2e-3) == pytest.approx(50.0)
    # 67 GFLOP at 67 TFLOP/s is 1 ms, and binds over 1 byte
    assert peaks.roofline_share(1, 67e9, 4e-3) == pytest.approx(25.0)
    assert peaks.roofline_share(0, 0, 1.0) is None
    assert peaks.roofline_share(1e9, 0, 0.0) is None


def test_busy_union_and_gaps():
    busy, gaps = capture._busy_and_gaps([(5, 8), (1, 3), (2, 4), (9, 12)], 0, 10)
    assert busy == 3 + 3 + 1
    assert gaps == [(0, 1), (4, 5), (8, 9)]


def test_kernel_time_by_name():
    red = Reduced(window_s=1, busy_s=1, ranges={}, ops={}, kernels={
        "void (anonymous namespace)::l2_topk_qbuf_kernel<16, float>(float const*, int)": 2.0,
        "l2_topk_qbuf_count_kernel(int const*)": 0.5,
        "void (anonymous namespace)::pq_adc_topk_qbuf_kernel<unsigned char, 1>(float)": 3.0,
        "(anonymous namespace)::dedup_topk_kernel(float const*)": 1.0,
        "aten::sort": 9.0}, idle={}, events=0, unmatched=0, lost=0)
    assert red.kernel_ms("l2_topk_qbuf") == 2.5
    assert red.kernel_ms("pq_adc_topk_qbuf") == 3.0
    assert red.kernel_ms("dedup_topk") == 1.0
    assert red.kernel_ms("missing") == 0.0


def test_roofline_reader_divides_the_work_by_the_kernel_time():
    """1 ms of bytes at the HBM rate over the 4 ms the trace gives the
    kernel's events reads 25%."""
    import types

    mod = _layer("dedup_topk_roofline")
    hooks = capture.Hooks()
    hooks.calls["dedup_topk"] = [{"rows": 1, "pool": int(3.35e9 / 8) - 1, "k": 1}]
    red = Reduced(window_s=1, busy_s=1, ranges={}, ops={}, idle={}, events=0, unmatched=0,
                  lost=0, kernels={"(anonymous namespace)::dedup_topk_kernel(float)": 4.0})
    r = types.SimpleNamespace(reduced=red, hooks=hooks)
    assert mod.read(r) == pytest.approx(25.0)
    r.reduced = None
    assert mod.read(r) is None
