"""The harness end to end on the CPU at a toy size, through the port's
plain PyTorch path: the result's keys, the metrics each kind of run reports,
and ``correct`` on a sound run."""
from __future__ import annotations

import json

import pytest

from lirabench import run

SEED = 2**31 + 7


def _result(root, cell, trace):
    return run.run_cell(root, cell, SEED, 0.5, trace, device="cpu", log=lambda m: None)


def test_untraced_run_reports_its_end_to_end_metrics(toy_root):
    res = _result(toy_root, "toy.batch", False)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"recall_at_100", "setup_s", "qps"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] == 1
    assert set(res["checks"]) == {"recall", "dist_gap", "dup_ids", "unsorted", "bad_ids",
                                  "unanswered"}
    json.dumps(res)


def test_traced_run_reports_what_the_cpu_can_read(toy_root):
    """Without a card no device time is read, so the device-trace metrics are
    left out, never reported as 0; the spans and counters the CPU run reads
    are the program's to add."""
    res = _result(toy_root, "toy.batch", True)
    assert res["correct"] is True, res["checks"]
    bench = json.loads((toy_root / "BENCHMARK.json").read_text())
    source = {m["name"]: m["source"] for m in bench["per_layer"]}
    assert res["metrics"] and not {n for n in res["metrics"] if source[n] == "device_trace"}
    assert "busy_s" not in res["device"] and "breakdown" not in res


@pytest.mark.parametrize("rows", ["uniform", "zipf"])
def test_same_seed_same_inputs(rows):
    """The base and the query set are the configuration's (its data_seed and
    query_seed); the run's seed orders (or, by Zipf, draws) the window's rows
    from the query set: the same seed gives the same bytes, another seed the
    same queries in another order, and no two batches are the same rows."""
    import numpy as np

    from lirabench import data
    from lirabench.modes.closed import Mode
    from lirabench.tests.conftest import TOY_CONFIG

    spec = TOY_CONFIG["data"]
    b1, q1 = data.make_vectors(spec, 500, 64, "cpu")
    b2, q2 = data.make_vectors(spec, 500, 64, "cpu")
    assert b1.equal(b2) and q1.equal(q2) and not q1.equal(b1[:64])
    assert b1.shape == (500, 16) and q1.shape == (64, 16)
    mix = {"batch_rows": 16, "rows": rows, "zipf_s": 1.0, "ranking_seed": 2, "warm_calls": 1}
    m1, m2, m3 = Mode(mix, q1, SEED), Mode(mix, q1, SEED), Mode(mix, q1, SEED + 1)
    assert np.array_equal(m1.stream, m2.stream) and not np.array_equal(m1.stream, m3.stream)
    assert np.array_equal(m1.stream, q1.numpy()[m1.idx])
    if rows == "uniform":
        assert sorted(m1.idx) == sorted(m3.idx) == list(range(64))
    else:
        # one ranking for every seed: the same query is the most popular
        top = [np.bincount(m.idx, minlength=64).argmax() for m in (m1, m3)]
        assert top[0] == top[1]
    batches = [tuple(m1.batch(j)[0]) for j in range(12)]
    assert len(set(batches)) == 12


def test_main_refuses_without_a_card(capsys, monkeypatch):
    """On a machine without CUDA the command prints no result and fails."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "lira-ann.batch8k", "--seed", str(SEED), "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(cuda_device):
    """One short run of the first cell on the card: a result with correct."""
    res = run.run_cell(run.ROOT, "lira-ann.batch8k", SEED, 2.0, False, log=lambda m: None)
    assert res["correct"] is True, res["checks"]
