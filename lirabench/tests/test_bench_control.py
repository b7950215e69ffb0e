"""``correct`` comes out false for the control and for the faults a cell can
have: the reference put in the program's place at a lower precision (the
configuration's vectors stored in bfloat16), half of a batch left out, an
answer altered where it is produced, and rows handed back to the wrong
query. Each run skips the look for a chip and drives the rest of a run,
with the timed path broken underneath."""
from __future__ import annotations

import json

import pytest
import torch

from lirabench import run
from lirabench.tests.conftest import TOY_CONFIG, make_toy_root


def _run(root, cell="toy.batch"):
    return run.run_cell(root, cell, 11, 0.4, False, device="cpu", log=lambda m: None)


def _failed(res):
    return {n for n, c in res["checks"].items()
            if (n == "recall" and c["value"] < c["limit"]) or (n != "recall" and c["value"] > c["limit"])}


def test_sound_run_is_correct(toy_root):
    res = _run(toy_root)
    assert res["correct"] and not _failed(res)


def test_control_bfloat16_store_is_not_correct(tmp_path):
    config = json.loads(json.dumps(TOY_CONFIG))
    config["build"]["store_dtype"] = "bfloat16"
    res = _run(make_toy_root(tmp_path, config))
    assert res["correct"] is False
    assert "dist_gap" in _failed(res)


def _wrap_merge(monkeypatch, change):
    from repro_torch.kernels import ops

    inner = ops.dedup_topk

    def broken(dists, ids, k, **kw):
        d, i = inner(dists, ids, k, **kw)
        return change(d.clone(), i.clone())

    monkeypatch.setattr(ops, "dedup_topk", broken)


def test_half_the_batch_left_out_is_not_correct(toy_root, monkeypatch):
    def half(d, i):
        n = d.shape[0] // 2
        d[n:], i[n:] = torch.inf, -1
        return d, i

    _wrap_merge(monkeypatch, half)
    res = _run(toy_root)
    assert res["correct"] is False and "recall" in _failed(res)


def test_an_answer_altered_where_it_is_produced_is_not_correct(toy_root, monkeypatch):
    def alter(d, i):
        i[0, 0] = (i[0, 0] + 1) % TOY_CONFIG["n_points"]
        return d, i

    _wrap_merge(monkeypatch, alter)
    res = _run(toy_root)
    assert res["correct"] is False and "dist_gap" in _failed(res)


def test_rows_handed_to_the_wrong_request_are_not_correct(toy_root, monkeypatch):
    """A batch's answers handed back to its queries in the wrong order."""
    from repro_torch.serving.engine import LiraEngine

    inner = LiraEngine.search

    def shifted(self, queries, *args, **kw):
        res = inner(self, queries, *args, **kw)
        if len(res.ids) > 1:
            res.ids, res.dists = res.ids[::-1].copy(), res.dists[::-1].copy()
        return res

    monkeypatch.setattr(LiraEngine, "search", shifted)
    res = _run(toy_root)
    assert res["correct"] is False and "dist_gap" in _failed(res)
