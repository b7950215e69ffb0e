"""A toy of ``bigann-u8``: a uint8 configuration served by the u8 tier
through ``run.py`` on the CPU. The exact integer scan reads ``correct`` with
no distance gap; the configuration's own control (a residual-PQ shortlist
with an exact rerank of k) and half of every batch left out read ``correct``
false. Its per-layer readers read the program's counter and leave out what
the CPU cannot read."""
from __future__ import annotations

import json

import pytest

from lirabench import limits, run
from lirabench.tests.conftest import TOY_CONFIG

REAL = json.loads((run.ROOT / "lirabench" / "configs" / "bigann-u8.json").read_text())
TOY_U8 = json.loads(json.dumps(TOY_CONFIG))
TOY_U8["build"].update(tier="u8", sigma=-1.0, nprobe_max=TOY_U8["build"]["n_partitions"])
TOY_U8["data"].update(dtype="uint8")
TOY_U8["checks"] = {"recall": 1.0, "dist_gap": 0.0}
TOY_U8["control"] = {"build": {**REAL["control"]["build"], "pq_m": 4, "pq_ks": 16}}
CELL = "toy-bigann.batch"
SEED = 2**31 + 23


def _add(root, config=TOY_U8):
    (root / "lirabench" / "configs" / "toy-bigann.json").write_text(json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-bigann", "source": "toy",
                             "file": "lirabench/configs/toy-bigann.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": CELL, "config": "toy-bigann", "traffic": "toy-batch",
                               "chips": 1, "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "bigann-u8.batch8k" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, trace=False, overrides=None):
    return run.run_cell(root, CELL, SEED, 0.4, trace, device="cpu", overrides=overrides,
                        log=lambda m: None)


def test_the_u8_tier_reads_correct_with_no_gap(toy_root):
    res = _run(_add(toy_root))
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["dist_gap"]["value"] == 0.0
    assert res["checks"]["recall"]["value"] == 1.0
    assert set(res["metrics"]) == {"qps", "recall_at_100", "setup_s"}


def test_its_control_is_not_correct(toy_root):
    res = _run(_add(toy_root), overrides=limits.control_of(TOY_U8))
    assert res["correct"] is False
    assert res["checks"]["recall"]["value"] < TOY_U8["checks"]["recall"]


def test_half_the_batch_left_out_is_not_correct(toy_root):
    install, remove = limits.half_left_out()
    install()
    try:
        res = _run(_add(toy_root))
    finally:
        remove()
    assert res["correct"] is False
    assert res["checks"]["recall"]["value"] < 0.6


def test_a_traced_run_reads_one_byte_a_query_element(toy_root):
    """The query bytes a row are the width's bytes; the kernel's roofline
    needs device time, which the CPU has none of."""
    res = _run(_add(toy_root), trace=True)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["query_bytes_per_row.batch"]["value"] == TOY_U8["data"]["dim"]
    assert "l2u8_topk_qbuf_roofline" not in res["metrics"]


def test_the_real_configuration_names_its_control_and_holds_no_gap():
    assert limits.control_of(REAL) == REAL["control"]
    assert REAL["data"]["dtype"] == "uint8" and REAL["build"]["tier"] == "u8"
    assert REAL["checks"]["dist_gap"] == 0.0
    assert set(REAL["reduced"]) == {"n_points"}
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cfg = next(c for c in bench["configs"] if c["name"] == "bigann-u8")
    assert cfg["reduced"] == ["n_points"]


@pytest.mark.parametrize("name", ["l2u8_topk_qbuf_roofline", "query_bytes_per_row.batch"])
def test_its_readers_read_nothing_without_a_capture(name):
    cell = run.Cell.load(run.ROOT, "bigann-u8.batch8k")
    reader = cell.reader("layers", name)
    assert reader.read(run.Reading(cell=cell, window=None, setup_s=0.0)) is None
