"""The rerank reader ``rerank_topk_qbuf_roofline``: its count of work against
a count by hand, and its silence where there is nothing to read."""
from __future__ import annotations

import importlib.util
import pathlib
import types

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


def test_rerank_work_by_hand():
    mod = _layer("rerank_topk_qbuf_roofline")
    # 2 buckets of 6 rows, d 4, a 3-entry shortlist, k 2; query rows 0-2 and
    # the empty row 3. Bucket 0 holds 6 live rows, its slots 0 and 1 occupied,
    # shortlisting {1, 2, 4} and {4, 5, 0}; bucket 1 holds 2 live rows (0 and
    # 5), its slot 0 occupied, shortlisting {0, 5, -1}
    q_pad = torch.zeros((4, 4))
    qbuf = torch.tensor([[0, 2, 3], [1, 3, 3]], dtype=torch.int32)
    vecs = torch.zeros((2, 6, 4), dtype=torch.bfloat16)
    ids = torch.tensor([[0, 1, 2, 3, 4, 5], [6, -1, -1, -1, -1, 11]], dtype=torch.int32)
    sl = torch.tensor([[[1, 2, 4], [4, 5, 0], [0, 1, 2]],
                       [[0, 5, -1], [3, 3, 3], [5, 5, 5]]], dtype=torch.int32)
    rec = mod.hook({}, q_pad, qbuf, vecs, ids, sl, 2, impl="cuda")
    assert rec["occ"].tolist() == [2, 1] and rec["per"].tolist() == [3, 2]
    assert (rec["d"], rec["itemsize"], rec["rk"], rec["k"]) == (4, 2, 3, 2)
    nbytes, flops = mod.work(**rec)
    # rows read at least: 3 of bucket 0 and 2 of bucket 1 (the shortlists
    # name 5 and 2), once, at 4·2 + 4 bytes; 3 occupied slots read 3
    # shortlist entries and 4 query floats and write 2 (dist, id)
    assert float(nbytes) == 5 * (4 * 2 + 4) + 3 * (3 * 4 + 4 * 4 + 2 * 8)
    # the entries naming a row: 3 + 3 in bucket 0, 2 in bucket 1
    assert float(flops) == 8 * 2 * 4
    # an unprobed bucket reads nothing
    rec = mod.hook({}, q_pad, torch.tensor([[0, 3, 3], [3, 3, 3]], dtype=torch.int32), vecs,
                   ids, sl, 2)
    assert [float(x) for x in mod.work(**rec)] == [3 * (4 * 2 + 4) + (3 * 4 + 4 * 4 + 2 * 8),
                                                   3 * 2 * 4]


def test_rerank_reader_reads_nothing_without_a_capture():
    mod = _layer("rerank_topk_qbuf_roofline")
    assert mod.read(types.SimpleNamespace(reduced=None, hooks=None)) is None
    red = Reduced(window_s=1, busy_s=1, ranges={}, ops={}, idle={}, events=0, unmatched=0,
                  lost=0, kernels={"void (anonymous namespace)::rerank_topk_qbuf_kernel<float, "
                                   "4>(float const*)": 2.0})
    assert red.kernel_ms("rerank_topk_qbuf") == 2.0
    # a capture, but no call of the op in the window (a program without it)
    assert mod.read(types.SimpleNamespace(reduced=red, hooks=capture.Hooks())) is None
    hooks = capture.Hooks()
    none = torch.zeros(1, dtype=torch.float64)
    call = {"d": 128, "itemsize": 4, "rk": 400, "k": 100}
    hooks.calls["rerank_topk_qbuf"] = [{"occ": none, "per": none, **call}]
    assert mod.read(types.SimpleNamespace(reduced=red, hooks=hooks)) is None   # no work
    # one probed partition of 3.35e9 / 516 rows, each pair's shortlist naming
    # all of them, and no pair's own bytes: ~1 ms of bytes over the 2 ms of
    # the kernel's events
    hooks.calls["rerank_topk_qbuf"] = [{"occ": torch.ones(1, dtype=torch.float64),
                                        "per": torch.full((1,), 3.35e9 / 516,
                                                          dtype=torch.float64),
                                        **call, "rk": 0, "d": 128, "k": 0}]
    share = mod.read(types.SimpleNamespace(reduced=red, hooks=hooks))
    assert share == pytest.approx(100 * (3.35e9 + 512) / peaks.HBM_BYTES_PER_S / 2e-3, rel=1e-6)
