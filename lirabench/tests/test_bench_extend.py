"""A later change adds a configuration, a traffic mix, a cell and a metric
as new files and manifest entries, and edits no file of the harness."""
from __future__ import annotations

import json

from lirabench import run
from lirabench.tests.conftest import TOY_CONFIG


def test_new_cell_config_mix_and_metric_are_files_and_entries(toy_root):
    lb = toy_root / "lirabench"
    before = {p: p.read_bytes() for p in lb.rglob("*") if p.is_file()}
    config = json.loads(json.dumps(TOY_CONFIG))
    config["build"].update(tier="f32")
    (lb / "configs" / "toy-f32.json").write_text(json.dumps(config))
    (lb / "traffic" / "toy-cycle.json").write_text(json.dumps(
        {"mode": "closed", "batch_rows": 32, "rows": "uniform", "warm_calls": 1}))
    (lb / "layers" / "rows_served.toy.py").write_text(
        '"""rows_served.toy: query rows answered in the window."""\n\n\n'
        "def read(r):\n    return float(r.window.rows)\n")
    bench = json.loads((toy_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-f32", "source": "toy",
                             "file": "lirabench/configs/toy-f32.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"].append({"name": "toy-f32.cycle", "config": "toy-f32",
                               "traffic": "toy-cycle", "chips": 1, "why": "toy"})
    bench["end_to_end"][0]["workloads"].append("toy-f32.cycle")        # qps
    bench["per_layer"].append({"name": "rows_served.toy", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "engine host",
                               "moves": "qps", "workloads": ["toy-f32.cycle"]})
    (toy_root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = run.run_cell(toy_root, "toy-f32.cycle", 9, 0.3, False, device="cpu",
                         log=lambda m: None)
    traced = run.run_cell(toy_root, "toy-f32.cycle", 9, 0.3, True, device="cpu",
                          log=lambda m: None)
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"qps", "recall_at_100", "setup_s"}
    assert traced["metrics"]["rows_served.toy"]["value"] > 0
    # the f32 tier probing every partition is exact
    assert plain["checks"]["recall"]["value"] == 1.0
    assert all(p.read_bytes() == b for p, b in before.items())
