"""The readers of the spans and counters inside the build and the serve step:
each returns a number from a synthetic reading, and None where the program
under test has no such counter or span (as a program without them has not)."""
from __future__ import annotations

import json
import types

import pytest

from lirabench import run

STAGES = ("kmeans", "train", "redundancy", "store", "tier")
READERS = [f"build_{s}_s" for s in STAGES] + ["kernel_build_s", "step_idle_ms.batch",
                                               "scan_rows_per_query.batch",
                                               "merge_pool_fill.batch"]


def _reader(name):
    return run.load_module(run.HERE / "layers" / f"{name}.py", f"test_{name}")


def _reading(registry=None, tracer=None, idle=None):
    return run.Reading(cell=None, window=types.SimpleNamespace(rows=0), setup_s=0.0,
                       registry=registry, tracer=tracer,
                       reduced=None if idle is None else types.SimpleNamespace(idle=idle))


@pytest.fixture
def process_registry(monkeypatch):
    from repro_torch.obs import metrics

    fresh = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_DEFAULT", fresh)
    return fresh


def test_the_nine_readers_are_in_the_manifest():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    named = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in READERS:
        assert named[name]["workloads"] == cells
        assert (run.HERE / "layers" / f"{name}.py").is_file()


def test_the_readers_read_synthetic_counters_and_spans(process_registry):
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.utils.clock import FakeClock

    build_s = process_registry.counter("lira_build_seconds_total")
    for i, stage in enumerate(STAGES):
        build_s.inc(1.5 + i, stage=stage)
    kernel_s = process_registry.counter("lira_kernel_build_seconds_total")
    kernel_s.inc(4.0, kernel="dedup_topk")
    kernel_s.inc(6.5, kernel="l2_topk_qbuf")

    reg = MetricsRegistry()
    reg.counter("lira_engine_rows_total").inc(200, tier="f32", impl="cuda")
    reg.counter("lira_engine_scan_pair_rows_total").inc(7_000, tier="f32", impl="cuda")
    pool = reg.counter("lira_engine_merge_pool_entries_total")
    pool.inc(4_000, kind="allocated", tier="f32", impl="cuda")
    pool.inc(30, kind="written", tier="f32", impl="cuda")
    tracer = Tracer(clock=FakeClock())
    for _ in range(4):
        with tracer.span("engine.search"):
            pass
    idle = {"engine.device": 0.004, "engine.sync": 0.002, "lira.scan": 0.010,
            "lira.merge": 0.0, "engine.post": 1.0, "no span": 2.0}

    got = {name: _reader(name).read(_reading(reg, tracer, idle)) for name in READERS}
    want = {f"build_{s}_s": 1.5 + i for i, s in enumerate(STAGES)}
    want.update({"kernel_build_s": 10.5, "step_idle_ms.batch": 4.0,
                 "scan_rows_per_query.batch": 35.0, "merge_pool_fill.batch": 0.0075})
    assert got == pytest.approx(want)


def test_the_readers_read_nothing_where_the_program_counts_nothing(process_registry):
    """A program without these counters and spans (an empty registry, a
    window with no ``lira.*`` span and no search) reads None, and a run off
    the card reads no idle."""
    from repro_torch.obs import MetricsRegistry, Tracer

    for reading in (_reading(), _reading(MetricsRegistry(), Tracer(), {"no span": 1.0})):
        assert {name: _reader(name).read(reading) for name in READERS} == dict.fromkeys(READERS)
    # the program's build without a registry counts, but the window is the CPU's
    process_registry.counter("lira_build_seconds_total").inc(2.0, stage="kmeans")
    assert _reader("build_kmeans_s").read(_reading()) == 2.0
    assert _reader("step_idle_ms.batch").read(_reading(tracer=Tracer())) is None


def test_a_program_without_the_stage_spans_reads_its_device_span_alone():
    """The parent of these spans names the step's idle ``engine.device``
    alone: the reader reads that."""
    from repro_torch.obs import Tracer
    from repro_torch.utils.clock import FakeClock

    tracer = Tracer(clock=FakeClock())
    for _ in range(2):
        with tracer.span("engine.search"):
            pass
    reading = _reading(None, tracer, {"engine.device": 0.005, "no span": 0.2})
    assert _reader("step_idle_ms.batch").read(reading) == pytest.approx(2.5)


def test_a_traced_toy_run_reports_the_program_counters(toy_root):
    """Off the card a traced run reads the build's stages and the window's
    counters, and no device-trace metric; no kernel is compiled there, so
    ``kernel_build_s`` is left out too."""
    res = run.run_cell(toy_root, "toy.batch", 2**31 + 7, 0.5, True, device="cpu",
                       log=lambda m: None)
    assert res["correct"] is True, res["checks"]
    bench = json.loads((toy_root / "BENCHMARK.json").read_text())
    source = {m["name"]: m["source"] for m in bench["per_layer"]}
    got = set(res["metrics"])
    assert not {n for n in got if source[n] == "device_trace"}
    assert got >= {f"build_{s}_s" for s in STAGES} | {"scan_rows_per_query.batch",
                                                     "merge_pool_fill.batch"}
    assert "kernel_build_s" not in got
    values = {n: m["value"] for n, m in res["metrics"].items()}
    assert all(values[f"build_{s}_s"] > 0 for s in STAGES)
    # the toy probes every partition without overflow: its compact pool is full
    assert 0 < values["merge_pool_fill.batch"] <= 1
    assert values["scan_rows_per_query.batch"] > 0
