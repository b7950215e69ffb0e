"""The port's spans and counters inside the build and the serve step, on the
CPU: the five ``build.*`` stages under ``build`` and their seconds; the serve
step's four ``lira.*`` stages a rank and ``engine.sync`` under each
``engine.device``, and each stage's span against its profiler range; the
scan's live rows and the merge pool's entries against a NumPy recount from
the dispatch buffer and the occupancy plane; the kernel-compile counters
against a stubbed nvcc."""
import dataclasses
import subprocess
import time

import numpy as np
import pytest
import torch

from _torch_engines import tier_engines
from repro_torch.data.synthetic import make_vector_dataset
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.obs import RANGES, MetricsRegistry, Tracer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.api import BuildConfig, SearchRequest
from repro_torch.serving.engine import LiraEngine

TIERS = ["f32", "pq", "residual_pq"]
STAGES = ("kmeans", "train", "redundancy", "store", "tier")
SCANS = ("l2_topk_qbuf", "pq_adc_topk_qbuf")


@pytest.fixture(scope="module")
def engines():
    return tier_engines()


def _with_holes(eng, seed=5):
    """``eng`` over a copy of its store with about a third of the slots
    free, so partitions hold different numbers of live rows."""
    occ = eng.store["occupancy"].clone()
    occ &= torch.from_numpy(np.random.default_rng(seed).random(tuple(occ.shape)) > 0.35)
    return dataclasses.replace(eng, store=dict(eng.store, occupancy=occ))


# ---------------------------------------------------------------- the build


@pytest.mark.parametrize("tier", ["f32", "residual_pq"])
def test_build_stages_nest_under_build(tier):
    ds = make_vector_dataset(n=800, n_queries=8, dim=16, n_modes=8, seed=2)
    tracer, reg = Tracer(), MetricsRegistry()
    t0 = time.perf_counter()
    eng = LiraEngine.build(ds.base, BuildConfig(n_partitions=8, k=5, eta=0.05,
                                                train_frac=0.3, epochs=2, tier=tier,
                                                pq_m=4, pq_ks=16),
                           device="cpu", tracer=tracer, metrics=reg)
    wall = time.perf_counter() - t0
    root, = tracer.finished("build")
    assert root.parent_id is None
    assert root.attrs == {"rows": 800, "partitions": 8, "tier": tier}
    inside = sorted(tracer.children(root), key=lambda sp: sp.span_id)
    assert [sp.name for sp in inside] == [f"build.{s}" for s in STAGES]
    assert [sp.name for sp in tracer.finished()] == [f"build.{s}" for s in STAGES] + ["build"]
    seconds = reg.counter("lira_build_seconds_total")
    per = [seconds.value(stage=s) for s in STAGES]
    assert min(per) > 0 and sum(per) <= wall
    # the engine keeps what it was built with
    assert eng.tracer is tracer and eng.metrics is reg


def test_build_without_a_registry_counts_into_the_default(monkeypatch):
    fresh = MetricsRegistry()
    monkeypatch.setattr(obs_metrics, "_DEFAULT", fresh)
    ds = make_vector_dataset(n=600, n_queries=8, dim=16, n_modes=8, seed=3)
    eng = LiraEngine.build(ds.base, BuildConfig(n_partitions=8, k=5, eta=0.0, train_frac=0.3,
                                                epochs=1), device="cpu")
    seconds = fresh.counter("lira_build_seconds_total")
    assert all(seconds.value(stage=s) > 0 for s in STAGES)
    assert eng.tracer is None and eng.metrics is None


# ----------------------------------------------------------- the serve step


@pytest.mark.parametrize("tier", TIERS)
def test_each_rank_opens_the_four_stages_then_the_sync(engines, tier):
    """Over a 1 × 2 mesh: rank 0's four stages, rank 1's, the cross-rank
    merge on rank 0, then ``engine.sync``, all inside ``engine.device``."""
    eng_all, q = engines
    eng = dataclasses.replace(eng_all[tier], mesh=make_test_mesh(1, 2, device="cpu"),
                              tracer=Tracer(), metrics=MetricsRegistry())
    eng.search(SearchRequest(queries=q))
    device, = eng.tracer.finished("engine.device")
    inside = sorted(eng.tracer.children(device), key=lambda sp: sp.span_id)
    want = [(name, {"rank": j}) for j in (0, 1) for name in RANGES]
    want += [("lira.merge", {"rank": 0, "ranks": 2}), ("engine.sync", {})]
    assert [(sp.name, sp.attrs) for sp in inside] == want
    # nothing of the step opens a span of its own below a stage
    assert not any(eng.tracer.children(sp) for sp in inside)


def test_a_stage_span_tracks_its_profiler_range(engines):
    """In a CPU profile each ``lira.*`` span starts and ends within 1 ms of
    its profiler range, after one common shift of the two clocks (the
    median of the starts' differences). The second of two searches is
    compared: a profile's first range pays the profiler's own set-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng_all, q = engines
    eng = dataclasses.replace(eng_all["residual_pq"], mesh=make_test_mesh(1, 2, device="cpu"),
                              tracer=Tracer(), metrics=MetricsRegistry())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            eng.search(SearchRequest(queries=q))
    ranges = sorted((ev for ev in prof.events()
                     if ev.name in RANGES and ev.device_type == DeviceType.CPU),
                    key=lambda ev: ev.time_range.start)[9:]
    spans = sorted((sp for sp in eng.tracer.finished() if sp.name in RANGES),
                   key=lambda sp: sp.t_start)[9:]
    assert len(spans) == len(ranges) == 9
    assert [ev.name for ev in ranges] == [sp.name for sp in spans]
    shift = np.median([ev.time_range.start - sp.t_start * 1e6 for ev, sp in zip(ranges, spans)])
    for ev, sp in zip(ranges, spans):
        assert abs(ev.time_range.start - (sp.t_start * 1e6 + shift)) < 1e3, sp
        assert abs(ev.time_range.end - (sp.t_end * 1e6 + shift)) < 1e3, sp


def _recount(monkeypatch, eng, q, sigma):
    """One search of ``eng`` and the NumPy recount of what it hands the
    scan and the merge, from the dispatch buffers its ranks handed the
    scan kernel (in rank order) and the store's occupancy plane."""
    seen = []
    for name in SCANS:
        inner = getattr(kops, name)

        def wrapped(plane, qbuf, *args, _inner=inner, **kw):
            seen.append((qbuf.numpy().copy(), plane.shape[0] - 1))
            return _inner(plane, qbuf, *args, **kw)

        monkeypatch.setattr(kops, name, wrapped)
    res = eng.search(SearchRequest(queries=q, sigma=sigma))
    qbuf = np.concatenate([s[0] for s in seen])                 # [B, q_cap]
    q_row = seen[0][1]
    occ = (qbuf < q_row).sum(1)
    live = eng.store["occupancy"].numpy().sum(1)
    nprobe = min(eng.cfg.nprobe_max, eng.cfg.n_partitions)
    return res, {"pairs": int((occ * live).sum()), "written": int(occ.sum()) * eng.cfg.k,
                 "allocated": len(seen) * q_row * nprobe * eng.cfg.k}


@pytest.mark.parametrize("sigma", [-1.0, 0.5])
@pytest.mark.parametrize("model", [1, 2])
@pytest.mark.parametrize("tier", TIERS)
def test_scan_and_pool_counts_match_a_numpy_recount(engines, monkeypatch, tier, model, sigma):
    eng_all, q = engines
    eng = dataclasses.replace(_with_holes(eng_all[tier]),
                              mesh=make_test_mesh(1, model, device="cpu"),
                              metrics=MetricsRegistry())
    res, want = _recount(monkeypatch, eng, q, sigma)
    lbl = {"tier": tier, "impl": "ref"}
    pool = eng.metrics.counter("lira_engine_merge_pool_entries_total")
    assert eng.metrics.counter("lira_engine_scan_pair_rows_total").value(**lbl) == want["pairs"]
    assert pool.value(kind="written", **lbl) == want["written"]
    assert pool.value(kind="allocated", **lbl) == want["allocated"]
    # every pair written is a probe that was not dropped
    assert want["written"] == (res.nprobe_eff.sum() - res.overflow) * eng.cfg.k
    if sigma == -1.0:
        # every query probes every partition, and q_cap holds them all
        assert res.overflow == 0
        assert want["pairs"] == len(q) * int(eng.store["occupancy"].sum())


def test_make_bundle_counts_nothing(engines):
    """The serve step without ``counts`` returns the reference's five
    outputs and leaves no count behind."""
    from repro_torch.serving.engine import make_serve_step, place_ranks

    eng_all, q = engines
    eng = eng_all["f32"]
    mesh = make_test_mesh(device="cpu")
    step = make_serve_step(eng.cfg, 16, sigma=-1.0, impl="ref", k=eng.cfg.k, mesh=mesh)
    qp = torch.zeros((16, eng.cfg.dim))
    qp[:len(q)] = torch.from_numpy(q)
    valid = torch.arange(16) < len(q)
    ranks = place_ranks(eng.model, eng.store, eng.cfg, mesh)
    plain = step(ranks, qp, valid)
    counts = {}
    counted = step(ranks, qp, valid, tracer=Tracer(), counts=counts)
    assert len(plain) == 5
    for a, b in zip(plain, counted):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(counts) == {"scan_pair_rows", "pool_written", "pool_allocated"}


# ------------------------------------------------------------- the kernels


class _FakeNvcc:
    """``subprocess.Popen`` for one nvcc run: writes the ``-o`` file."""

    returncode = 0

    def __init__(self, cmd, **_):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as fh:
            fh.write(b"\x7fELF")
        time.sleep(0.01)

    def communicate(self):
        return "ptxas info: 0 bytes stack frame\n", None


def test_kernel_compile_counters_count_one_stubbed_build(monkeypatch, tmp_path):
    fresh = MetricsRegistry()
    monkeypatch.setattr(obs_metrics, "_DEFAULT", fresh)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    seconds = _build.build_all(("dedup_topk",))
    build_s = fresh.counter("lira_kernel_build_seconds_total")
    assert build_s.value(kernel="dedup_topk") == seconds["dedup_topk"] > 0
    assert build_s.total() == seconds["dedup_topk"]
    # the library is there now: a second call runs no nvcc and counts nothing
    assert _build.build_all(("dedup_topk",)) == {"dedup_topk": 0.0}
    assert build_s.total() == seconds["dedup_topk"]


def test_live_rows_are_counted_again_after_an_in_place_write(engines):
    """The block keeps its live-row count across calls, and a write into
    the occupancy plane (a same-shape mutation, or one made through another
    engine over the same store) counts them again."""
    eng_all, q = engines
    eng = dataclasses.replace(_with_holes(eng_all["f32"]), metrics=MetricsRegistry())
    pairs = eng.metrics.counter("lira_engine_scan_pair_rows_total")
    eng.search(SearchRequest(queries=q))
    first = pairs.total()
    assert first == len(q) * int(eng.store["occupancy"].sum())         # σ = -1
    eng.store["occupancy"][0, :] = False                                # written in place
    eng.search(SearchRequest(queries=q))
    assert pairs.total() - first == len(q) * int(eng.store["occupancy"].sum())
