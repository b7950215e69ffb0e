"""The port's observability against the reference's properties, on the CPU:
the metrics registry, histogram bucket math and span nesting on FakeClock
(the unit tests of ``tests/test_obs.py``, run on ``repro_torch.obs`` and
``repro_torch.utils.clock``); held against ``repro.obs`` on the same
inputs: the histogram's counts, sums, quantiles and text, the Tracer's ring,
JSONL export and sinks, the engine's and front-end's spans and metric
series, and the port's exposition read by the reference's
``parse_exposition``; and the serving gates: engine and front-end counters
and stage sums, tracing on and off bit-identical, the profiler ranges on and
off bit-identical, and ``profile_capture`` writing a trace that names the
serve step's four ranges.
"""
import dataclasses
import json

import numpy as np
import pytest

from _torch_engines import tier_engines
from repro.obs.metrics import parse_exposition as jax_parse_exposition
from repro_torch.configs.base import FrontendConfig
from repro_torch.obs import (NOOP, RANGES, MetricsRegistry, Tracer, default_registry,
                             parse_exposition, profile_capture, range_times)
from repro_torch.obs.metrics import LATENCY_BUCKETS_MS, Histogram
from repro_torch.serving.api import SearchRequest
from repro_torch.serving.engine import LiraEngine
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.utils.clock import FakeClock

TIERS = ["f32", "pq", "residual_pq"]

# ------------------------------------------------------------------ registry


def test_counter_inc_value_labels():
    reg = MetricsRegistry()
    c = reg.counter("hits", "help text")
    c.inc(tier="f32")
    c.inc(2, tier="pq")
    c.inc(tier="pq")
    assert c.value(tier="f32") == 1
    assert c.value(tier="pq") == 3
    assert c.value(tier="nope") == 0
    assert c.total() == 4
    assert c.total(tier="pq") == 3


def test_counter_rejects_decrease():
    c = MetricsRegistry().counter("c")
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)


def test_registry_get_or_create_and_kind_conflict():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError, match="already registered as counter"):
        reg.gauge("x")
    reg.histogram("h")
    with pytest.raises(ValueError, match="different buckets"):
        reg.histogram("h", buckets=(1.0, 2.0))
    assert reg.get("x") is reg.counter("x")
    assert reg.get("absent") is None
    assert "x" in reg.names() and "h" in reg.names()


def test_gauge_last_write_wins():
    g = MetricsRegistry().gauge("q_cap")
    g.set(2.0)
    g.set(4.0)
    assert g.value() == 4.0


def test_default_registry_is_shared():
    assert default_registry() is default_registry()


# ----------------------------------------------------------------- histogram


def test_latency_buckets_log_spaced():
    """Fixed log-spaced edges: 4 per decade, constant ratio 10^0.25, spanning
    tens of microseconds to tens of seconds of milliseconds-denominated
    latency."""
    edges = np.asarray(LATENCY_BUCKETS_MS)
    ratios = edges[1:] / edges[:-1]
    np.testing.assert_allclose(ratios, 10 ** 0.25, rtol=1e-12)
    assert edges[0] == pytest.approx(10 ** -1.5)
    assert edges[-1] == pytest.approx(10 ** 4)


def test_histogram_bucket_assignment_le_semantics():
    h = Histogram("h", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 1.0, 5.0, 10.0, 99.0, 1000.0):
        h.observe(v)
    # le-semantics: a value equal to an edge lands in that edge's bucket
    np.testing.assert_array_equal(h.counts(), [2, 2, 1, 1])
    assert h.count() == 6
    assert h.sum() == pytest.approx(0.5 + 1.0 + 5.0 + 10.0 + 99.0 + 1000.0)


def test_histogram_rejects_unsorted_buckets():
    with pytest.raises(ValueError, match="strictly increasing"):
        Histogram("h", buckets=(2.0, 1.0))


def test_histogram_quantile_degenerate_is_exact():
    """All observations equal → min == max clamps the interpolation to the
    exact value, for any q (the FrontendStats p50==p99 contract)."""
    h = Histogram("h")
    for _ in range(10):
        h.observe(1.1)
    assert h.quantile(0.5) == 1.1
    assert h.quantile(0.99) == 1.1


def test_histogram_quantile_bounded_by_observations():
    h = Histogram("h")
    vals = np.linspace(0.2, 7.7, 40)
    h.observe_many(vals)
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        est = h.quantile(q)
        assert vals.min() <= est <= vals.max()
    # interpolation is monotone and roughly tracks the true quantile
    assert h.quantile(0.5) == pytest.approx(np.quantile(vals, 0.5), rel=0.5)
    assert h.quantile(0.25) <= h.quantile(0.75)


def test_histogram_empty_quantile_and_bad_q():
    h = Histogram("h")
    assert h.quantile(0.5) == 0.0
    h.observe(1.0)
    with pytest.raises(ValueError, match="outside"):
        h.quantile(1.5)


def test_histogram_observe_many_matches_loop():
    h1, h2 = Histogram("a"), Histogram("b")
    vals = np.random.default_rng(0).lognormal(0, 2, 200)
    h1.observe_many(vals, tier="x")
    for v in vals:
        h2.observe(v, tier="x")
    np.testing.assert_array_equal(h1.counts(tier="x"), h2.counts(tier="x"))
    assert h1.sum(tier="x") == pytest.approx(h2.sum(tier="x"))


def test_render_parse_round_trip():
    reg = MetricsRegistry()
    reg.counter("srv_total", "served").inc(3, tier="f32", impl="ref")
    reg.gauge("depth").set(7)
    h = reg.histogram("lat_ms", buckets=(1.0, 10.0))
    h.observe_many([0.5, 5.0, 50.0], frontend="fe0")
    text = reg.render()
    parsed = parse_exposition(text)
    assert parsed['srv_total{impl="ref",tier="f32"}'] == 3
    assert parsed["depth"] == 7
    assert parsed['lat_ms_bucket{frontend="fe0",le="1"}'] == 1
    assert parsed['lat_ms_bucket{frontend="fe0",le="10"}'] == 2
    assert parsed['lat_ms_bucket{frontend="fe0",le="+Inf"}'] == 3
    assert parsed['lat_ms_count{frontend="fe0"}'] == 3
    assert parsed['lat_ms_sum{frontend="fe0"}'] == pytest.approx(55.5)


def test_parse_exposition_rejects_garbage():
    with pytest.raises(ValueError, match="unparseable"):
        parse_exposition("this is { not a metric")
    with pytest.raises(ValueError, match="non-numeric"):
        parse_exposition("name notafloat")


# -------------------------------------------------------------------- tracer


def test_span_nesting_and_durations_on_fake_clock():
    clock = FakeClock()
    tr = Tracer(clock=clock)
    with tr.span("outer", tier="f32") as outer:
        clock.advance(1e-3)
        with tr.span("inner") as inner:
            clock.advance(2e-3)
        clock.advance(0.5e-3)
    assert inner.parent_id == outer.span_id
    assert outer.parent_id is None
    assert inner.duration_ms == pytest.approx(2.0)
    assert outer.duration_ms == pytest.approx(3.5)
    assert outer.attrs == {"tier": "f32"}
    # children recorded before parents (finish order), both retained
    assert [s.name for s in tr.finished()] == ["inner", "outer"]
    assert tr.children(outer) == [inner]
    assert tr.finished("inner") == [inner]


def test_span_attrs_set_inside_block():
    tr = Tracer(clock=FakeClock())
    with tr.span("s") as sp:
        sp.set(rows=32)
    assert tr.finished("s")[0].attrs == {"rows": 32}


def test_span_open_duration_is_zero():
    tr = Tracer(clock=FakeClock())
    with tr.span("s") as sp:
        assert sp.duration_ms == 0.0


def test_tracer_ring_is_bounded():
    tr = Tracer(clock=FakeClock(), max_spans=5)
    for i in range(12):
        with tr.span(f"s{i}"):
            pass
    assert [s.name for s in tr.finished()] == [f"s{i}" for i in range(7, 12)]


def test_jsonl_export_and_sink(tmp_path):
    clock = FakeClock()
    sunk = []
    tr = Tracer(clock=clock, sink=sunk.append)
    with tr.span("a"):
        clock.advance(1e-3)
    assert sunk and sunk[0]["name"] == "a"
    path = tmp_path / "spans.jsonl"
    assert tr.export_jsonl(str(path)) == 1
    rec = json.loads(path.read_text().splitlines()[0])
    assert rec["name"] == "a"
    assert rec["duration_ms"] == pytest.approx(1.0)
    assert rec["parent_id"] is None


def test_jsonl_file_sink(tmp_path):
    path = tmp_path / "stream.jsonl"
    tr = Tracer(clock=FakeClock(), sink=str(path))
    with tr.span("x"):
        pass
    with tr.span("y"):
        pass
    tr.close()
    names = [json.loads(line)["name"] for line in path.read_text().splitlines()]
    assert names == ["x", "y"]


def test_noop_tracer_is_inert():
    assert NOOP.enabled is False
    with NOOP.span("anything", tier="f32") as sp:
        sp.set(ignored=1)
        assert sp.duration_ms == 0.0
    assert NOOP.finished() == []


def test_reference_parser_reads_the_port_exposition():
    """The port's text exposition is the reference's format: the JAX
    package's parser reads it and finds the same series and values."""
    reg = MetricsRegistry()
    reg.counter("srv_total", "served").inc(3, tier="f32", impl="cuda")
    reg.gauge("depth").set(7.25)
    reg.histogram("lat_ms").observe_many([0.05, 2.0, 300.0, 2e5], frontend="fe0")
    text = reg.render()
    assert jax_parse_exposition(text) == parse_exposition(text)
    assert len(parse_exposition(text)) == 2 + len(LATENCY_BUCKETS_MS) + 3


def _reference_obs():
    from repro.obs import metrics as jax_metrics
    from repro.obs import trace as jax_trace
    from repro.utils.clock import FakeClock as JaxFakeClock
    return jax_metrics, jax_trace, JaxFakeClock


HIST_CASES = {
    "lognormal latencies": lambda rng: rng.lognormal(0.0, 2.0, 500),
    "degenerate": lambda rng: np.full(40, 1.1),
    "bucket edges": lambda rng: np.asarray(LATENCY_BUCKETS_MS)[rng.integers(0, 20, 200)],
    "past the top bucket": lambda rng: rng.uniform(1e5, 1e7, 50),
    "tiny and zero": lambda rng: np.concatenate([np.zeros(5), rng.uniform(0, 1e-3, 30)]),
    "one value": lambda rng: np.array([3.7]),
}


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_histogram_matches_reference(case):
    """The port's Histogram and the reference's take the same observations
    (half one by one, half through observe_many, over two label sets):
    equal bucket counts, count, sum, every quantile and rendered text."""
    jax_metrics, _, _ = _reference_obs()
    values = HIST_CASES[case](np.random.default_rng(len(case)))
    regs = (MetricsRegistry(), jax_metrics.MetricsRegistry())
    hists = [reg.histogram("lat_ms", "latency") for reg in regs]
    half = len(values) // 2
    for h in hists:
        for v in values[:half]:
            h.observe(float(v), frontend="a")
        h.observe_many(values[half:], frontend="a")
        h.observe_many(values[::3], frontend="b")
    port, ref = hists
    for lbl in ({"frontend": "a"}, {"frontend": "b"}, {"frontend": "none"}):
        np.testing.assert_array_equal(port.counts(**lbl), ref.counts(**lbl))
        assert port.count(**lbl) == ref.count(**lbl)
        assert port.sum(**lbl) == ref.sum(**lbl)
        for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert port.quantile(q, **lbl) == ref.quantile(q, **lbl), (lbl, q)
    assert regs[0].render() == regs[1].render()


def test_tracer_matches_reference(tmp_path):
    """The port's Tracer and the reference's run one nesting schedule on a
    FakeClock each, with a bounded ring and both sinks: equal spans in the
    ring, equal JSONL export, equal streamed records and file sink."""
    _, jax_trace, JaxFakeClock = _reference_obs()
    out = {}
    for name, tracer_cls, clock_cls in (("port", Tracer, FakeClock),
                                        ("ref", jax_trace.Tracer, JaxFakeClock)):
        clock = clock_cls(5.0)
        sunk = []
        tr = tracer_cls(clock=clock, sink=sunk.append, max_spans=7)
        file_tr = tracer_cls(clock=clock, sink=str(tmp_path / f"{name}.sink.jsonl"))
        for i in range(4):
            with tr.span("batch", i=i) as outer, file_tr.span("batch", i=i):
                clock.advance(0.25e-3 * (i + 1))
                for stage in ("prepare", "device", "post"):
                    with tr.span(f"engine.{stage}", stage=stage) as sp:
                        clock.advance(1e-4 * (i + 2))
                        sp.set(rows=8 * i)
                outer.set(rows=8 * i, tier="f32")
        file_tr.close()
        n = tr.export_jsonl(str(tmp_path / f"{name}.jsonl"))
        out[name] = dict(
            n=n, sunk=sunk, ring=[s.to_dict() for s in tr.finished()],
            children=[[c.span_id for c in tr.children(s)] for s in tr.finished("batch")],
            export=(tmp_path / f"{name}.jsonl").read_text(),
            sink=(tmp_path / f"{name}.sink.jsonl").read_text())
    assert out["port"] == out["ref"]
    assert out["port"]["n"] == 7 and len(out["port"]["sunk"]) == 16


def test_engine_and_frontend_spans_match_reference(tmp_path):
    """A JAX engine and the port's engine loaded from its save, each with a
    Tracer on a FakeClock, serve one search, one front-end batch and the
    four kinds of mutation: the same spans (names, nesting, attributes)
    and the same stage keys, and the same metric series and values."""
    from _torch_engines import jax_and_port

    jax_metrics, jax_trace, JaxFakeClock = _reference_obs()
    from repro.configs.base import FrontendConfig as JaxFrontendConfig
    from repro.serving.api import SearchRequest as JaxSearchRequest

    engines, q = jax_and_port(tmp_path / "ckpt", seed=43)
    pkgs = {"jax": (jax_trace.Tracer, JaxFakeClock, jax_metrics.MetricsRegistry,
                    JaxFrontendConfig, JaxSearchRequest),
            "torch": (Tracer, FakeClock, MetricsRegistry, FrontendConfig, SearchRequest)}
    out = {}
    for name, eng in engines.items():
        tracer_cls, clock_cls, registry_cls, cfg_cls, req_cls = pkgs[name]
        clock = clock_cls()
        eng.tracer, eng.metrics = tracer_cls(clock=clock), registry_cls()
        res = eng.search(q[:5], sigma=0.3)
        fe = eng.attach_frontend(cfg_cls(max_batch=8, max_wait_ms=1.0), clock=clock,
                                 name="fe")
        pends = [fe.submit(req_cls(queries=q[i])) for i in range(3)]
        clock.advance(2e-3)
        fe.poll()
        eng.delete(np.arange(0, 60, 3))
        eng.insert(q[:4] + np.float32(0.01), np.arange(4) + 5000)
        eng.compact()
        eng.maybe_repartition(force=True)
        out[name] = dict(
            spans=[(s.name, s.span_id, s.parent_id, s.duration_ms, s.attrs)
                   for s in eng.tracer.finished()],
            stages=(sorted(res.stats.stages), sorted(pends[0].result().stats.stages)),
            series=parse_exposition(eng.metrics.render()), epoch=eng.epoch)
        eng.frontend = None
    assert out["torch"] == out["jax"]
    assert out["torch"]["epoch"] == 4 and len(out["torch"]["spans"]) > 10


# --------------------------------------------------- serving integration


@pytest.fixture(scope="module")
def obs_engines():
    return tier_engines()


@pytest.mark.parametrize("tier", TIERS)
def test_tracing_is_bit_identical(obs_engines, tier):
    """Attaching a tracer and a registry changes no bit of the answer."""
    engines, q = obs_engines
    eng = engines[tier]
    req = SearchRequest(queries=q)
    eng.tracer, eng.metrics = None, None
    off = eng.search(req)
    eng.tracer, eng.metrics = Tracer(), MetricsRegistry()
    try:
        on = eng.search(req)
    finally:
        eng.tracer, eng.metrics = None, None
    np.testing.assert_array_equal(off.dists, on.dists)
    np.testing.assert_array_equal(off.ids, on.ids)
    np.testing.assert_array_equal(off.nprobe_eff, on.nprobe_eff)
    assert off.overflow == on.overflow
    assert off.stats.dedup_hits == on.stats.dedup_hits
    assert off.stats.stages is None
    assert set(on.stats.stages) == {"prepare", "device", "post"}


@pytest.mark.parametrize("tier", TIERS)
def test_profiler_ranges_are_bit_identical(obs_engines, tier, tmp_path):
    """A search inside ``profile_capture`` (the four ranges recorded) gives
    the bits of one outside it (the ranges idle)."""
    engines, q = obs_engines
    eng = engines[tier]
    off = eng.search(SearchRequest(queries=q))
    with profile_capture(str(tmp_path)) as prof:
        on = eng.search(SearchRequest(queries=q))
    assert prof is not None
    np.testing.assert_array_equal(off.dists, on.dists)
    np.testing.assert_array_equal(off.ids, on.ids)
    np.testing.assert_array_equal(off.nprobe_eff, on.nprobe_eff)
    assert off.overflow == on.overflow and off.stats.dedup_hits == on.stats.dedup_hits


def test_profile_capture_writes_a_trace_with_the_four_ranges(obs_engines, tmp_path):
    engines, q = obs_engines
    with profile_capture(str(tmp_path)) as prof:
        engines["residual_pq"].search(SearchRequest(queries=q))
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {ev.get("name") for ev in json.loads(traces[0].read_text())["traceEvents"]}
    assert set(RANGES) <= names
    # the CPU runs no device kernels: every range reads zero device time
    times = range_times(prof)
    assert list(times["ranges"]) == list(RANGES)
    assert all(rec["device_ms"] == 0.0 and rec["ops"] == {}
               for rec in times["ranges"].values())
    assert times["outside"] == {"device_ms": 0.0, "ops": {}}
    assert times["unmatched"] == {"events": 0, "device_ms": 0.0}
    assert times["lost"] == times["events"] == 0 and times["busy_ms"] == 0.0


def test_range_times_accounts_for_every_device_event():
    """On a hand-made event list (the CPU runs no kernels): a kernel under an
    aten op inside a range counts under the op, one launched directly from
    the range under its own name, a copy outside every range under
    "outside", a device event with no runtime call as unmatched, and a
    launch call with no device event as lost; the ranges' own device-side
    spans count nowhere."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, dev, i=0, parent=None, us=0.0):
        return SimpleNamespace(name=name, device_type=dev, id=i, cpu_parent=parent,
                               time_range=SimpleNamespace(start=0.0, end=us))

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    scan = ev("lira.scan", cpu)
    sort = ev("aten::sort", cpu, parent=ev("lira.merge", cpu))
    copy = ev("aten::copy_", cpu)
    events = [scan, sort, copy,
              ev("cudaLaunchKernel", cpu, 1, sort), ev("sort_kernel", gpu, 1, us=300.0),
              ev("cudaLaunchKernel", cpu, 2, scan), ev("l2_topk_qbuf", gpu, 2, us=120.0),
              ev("cudaMemcpyAsync", cpu, 3, copy), ev("Memcpy DtoH", gpu, 3, us=50.0),
              ev("orphan_kernel", gpu, 4, us=7.0),
              ev("cudaLaunchKernel", cpu, 5, scan), ev("cudaStreamSynchronize", cpu, 6, copy),
              ev("lira.scan", gpu, 7, us=900.0)]
    times = range_times(SimpleNamespace(events=lambda: events))
    assert times["ranges"]["lira.scan"] == {"device_ms": 0.12, "ops": {"l2_topk_qbuf": 0.12}}
    assert times["ranges"]["lira.merge"] == {"device_ms": 0.3, "ops": {"aten::sort": 0.3}}
    assert times["ranges"]["lira.probing"]["device_ms"] == 0.0
    assert times["outside"] == {"device_ms": 0.05, "ops": {"aten::copy_": 0.05}}
    assert times["unmatched"] == {"events": 1, "device_ms": 0.007}
    assert times["lost"] == 1 and times["events"] == 4
    assert times["busy_ms"] == pytest.approx(0.477)


def test_profile_capture_is_a_noop_without_a_directory(tmp_path):
    for empty in (None, ""):
        with profile_capture(empty) as prof:
            assert prof is None


def test_engine_metrics_and_stage_sum(obs_engines):
    engines, q = obs_engines
    eng = engines["f32"]
    reg = MetricsRegistry()
    eng.tracer, eng.metrics = Tracer(), reg
    try:
        res = eng.search(SearchRequest(queries=q))
        res2 = eng.search(SearchRequest(queries=q))
    finally:
        eng.tracer, eng.metrics = None, None
    lbl = {"tier": "f32", "impl": "ref"}
    assert reg.counter("lira_engine_searches_total").value(**lbl) == 2
    assert reg.counter("lira_engine_rows_total").value(**lbl) == 24
    hits = reg.counter("lira_engine_jit_cache_hits_total").value(**lbl)
    misses = reg.counter("lira_engine_jit_cache_misses_total").value(**lbl)
    assert hits + misses == 2 and res2.stats.cache_hit
    assert reg.histogram("lira_engine_nprobe_eff").count(**lbl) == 24
    # σ=-1 probes everything: nprobe_eff == n_partitions for every query
    assert reg.histogram("lira_engine_nprobe_eff").sum(**lbl) == 24 * 4
    assert reg.counter("lira_engine_probes_total").value(**lbl) == 24 * 4
    assert reg.gauge("lira_engine_q_cap_factor").value() == eng.cfg.q_cap_factor
    assert eng.overflow_rate() == 0.0
    # the stages are contiguous host timers inside the end-to-end span
    for r in (res, res2):
        assert r.stats.latency_ms > 0
        assert sum(r.stats.stages.values()) <= r.stats.latency_ms
        assert sum(r.stats.stages.values()) >= 0.5 * r.stats.latency_ms


def test_overflow_rate_counts_dropped_probes_once(obs_engines):
    """``lira_engine_probes_total`` counts attempted probes (before q_cap
    drops), so the rate is dropped / attempted."""
    engines, q = obs_engines
    src = engines["f32"]
    reg = MetricsRegistry()
    eng = dataclasses.replace(src, cfg=dataclasses.replace(src.cfg, q_cap_factor=0.25),
                              metrics=reg)
    res = eng.search(SearchRequest(queries=q))
    dropped = reg.counter("lira_engine_overflow_probes_total").total()
    attempted = reg.counter("lira_engine_probes_total").total()
    assert dropped == res.overflow > 0
    assert attempted == len(q) * src.cfg.n_partitions
    assert eng.overflow_rate() == pytest.approx(dropped / attempted)


def test_q_cap_bump_is_observable_and_drops_the_serve_cache(obs_engines):
    engines, q = obs_engines
    src = engines["f32"]
    reg = MetricsRegistry()
    eng = dataclasses.replace(src, cfg=dataclasses.replace(src.cfg, auto_q_cap=True),
                              metrics=reg)
    eng.search(SearchRequest(queries=q))
    assert len(eng._serve_cache) == 1
    factor0 = eng.cfg.q_cap_factor
    eng._maybe_bump_q_cap(5)
    assert reg.counter("lira_engine_q_cap_bumps_total").total() == 0
    assert len(eng._serve_cache) == 1
    eng._maybe_bump_q_cap(5)    # second consecutive overflow → bump
    assert reg.counter("lira_engine_q_cap_bumps_total").total() == 1
    assert reg.gauge("lira_engine_q_cap_factor").value() == 2 * factor0
    assert eng.cfg.q_cap_factor == 2 * factor0
    assert eng._serve_cache == {}
    assert not eng.search(SearchRequest(queries=q)).stats.cache_hit


# ------------------------------------------------------------ front-end obs


def _traced_frontend(eng, **cfg_kw):
    clock = FakeClock()
    reg = MetricsRegistry()
    tr = Tracer(clock=clock)   # spans on the virtual clock: exact durations
    defaults = dict(max_batch=8, max_wait_ms=2.0, max_queue=16)
    defaults.update(cfg_kw)
    fe = ServingFrontend(eng, FrontendConfig(**defaults), clock=clock, tracer=tr, metrics=reg)
    return fe, clock, reg, tr


def test_frontend_stage_breakdown_sums_to_latency(obs_engines):
    """Under one shared virtual clock every real-time stage is 0 ms wide and
    the queue wait is the whole latency: the stage sum is exactly e2e."""
    engines, q = obs_engines
    eng = engines["f32"]
    fe, clock, reg, tr = _traced_frontend(eng)
    eng.tracer = tr            # engine spans nest under frontend.batch
    try:
        pends = [fe.submit(SearchRequest(queries=q[i])) for i in range(2)]
        clock.advance(2.1e-3)
        fe.poll()
    finally:
        eng.tracer = None
    for p in pends:
        st = p.result().stats
        assert st.latency_ms == pytest.approx(2.1)
        assert st.stages["queue"] == pytest.approx(2.1)
        assert sum(st.stages.values()) == pytest.approx(st.latency_ms)
        assert set(st.stages) == {"queue", "assemble", "serve.prepare", "serve.device",
                                  "serve.post"}
    batch = tr.finished("frontend.batch")[0]
    search = tr.finished("engine.search")[0]
    assert search.parent_id == batch.span_id
    hs = reg.histogram("lira_frontend_stage_ms")
    assert hs.count(frontend=fe.name, stage="serve.device") == 1
    assert hs.count(frontend=fe.name, stage="assemble") == 1
    assert hs.count(frontend=fe.name, stage="scatter") == 1


def test_frontend_counters_and_isolation(obs_engines):
    """Two front-ends on one registry stay separate via the frontend label."""
    engines, q = obs_engines
    eng = engines["f32"]
    reg = MetricsRegistry()
    clock = FakeClock()
    fe_a = ServingFrontend(eng, FrontendConfig(max_batch=4), clock=clock, metrics=reg)
    fe_b = ServingFrontend(eng, FrontendConfig(max_batch=4), clock=clock, metrics=reg)
    assert fe_a.name != fe_b.name
    for i in range(4):
        fe_a.submit(SearchRequest(queries=q[i]))
    fe_a.drain()
    fe_b.submit(SearchRequest(queries=q[0]))
    fe_b.drain()
    assert fe_a.stats().served == 4 and fe_b.stats().served == 1
    assert fe_a.stats().batches == 1
    c = reg.counter("lira_frontend_served_total")
    assert c.value(frontend=fe_a.name) == 4 and c.value(frontend=fe_b.name) == 1


def test_frontend_qps_needs_two_completions(obs_engines):
    engines, q = obs_engines
    fe, clock, _, _ = _traced_frontend(engines["f32"])
    fe.submit(SearchRequest(queries=q[0]))
    clock.advance(5e-3)
    fe.poll()
    st = fe.stats()
    assert st.served == 1 and st.qps == 0.0
    assert st.p50_ms == pytest.approx(5.0)  # degenerate histogram is exact
    fe.submit(SearchRequest(queries=q[1]))
    clock.advance(5e-3)
    fe.poll()
    st = fe.stats()
    assert st.served == 2 and st.qps == pytest.approx(2 / 10e-3)


def test_shed_reasons_are_labeled(obs_engines):
    engines, q = obs_engines
    fe, clock, reg, _ = _traced_frontend(engines["f32"], max_queue=2, max_wait_ms=50.0)
    clock.advance(1.0)
    doa = fe.submit(SearchRequest(queries=q[0], deadline_ms=1.0), t_arrival=0.0)
    assert doa.result().stats.shed
    fe.submit(SearchRequest(queries=q[1]))
    fe.submit(SearchRequest(queries=q[2]))
    fe.submit(SearchRequest(queries=q[3], priority=1))    # displaces a waiter
    fe.submit(SearchRequest(queries=q[4]))                # rejected newcomer
    c = reg.counter("lira_frontend_shed_total")
    for reason in ("doa", "displaced", "rejected"):
        assert c.value(frontend=fe.name, reason=reason) == 1
    assert fe.stats().shed == 3
    fe.drain()
