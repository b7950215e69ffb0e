"""The port's serving front-end, on the CPU, against the reference's
properties (``tests/test_frontend.py``), all wall-clock-free: every deadline
fires because a FakeClock is advanced. Covered: size- and deadline-triggered
flushes (with per-request deadline_ms), power-of-two rounding of the size
trigger, incompatible requests split into groups (aliases coalesce),
admission control with priority displacement, telemetry quantiles and QPS,
charged service time, the open-loop simulation; coalesced batches
bit-identical to solo ``search()`` calls on the f32, pq and residual_pq tiers
(torch's CPU matmul gives one row the same bits in any batch here);
``search_one`` with and without a front-end; and mutations draining the
front-end so every batch is served within one epoch.

Against the JAX package: a JAX engine (``impl="ref"``) and the port's engine
loaded from its save each sit behind their package's front-end, and both
front-ends take the same request traces on a FakeClock (flushes, per-request
deadlines, bypass, compatibility groups, admission, priorities, backdated
arrivals, interpolated quantiles, three open-loop streams): equal
``FrontendStats``, equal scheduling of every request and answers under the
parity contract.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_engines import jax_and_port, raw_engine, tier_engines
from repro_torch import testing as rt
from repro_torch.configs.base import FrontendConfig
from repro_torch.data.synthetic import make_vector_dataset
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.serving.api import BuildConfig, SearchRequest
from repro_torch.serving.engine import LiraEngine, make_serve_step, place_ranks
from repro_torch.serving.frontend import ServingFrontend, simulate_open_loop
from repro_torch.serving.quantized import build_quantized_store
from repro_torch.utils.clock import FakeClock


@pytest.fixture(scope="module")
def tiny_engine():
    """A direct-store f32 engine (σ = -1) and a pool of 64 queries."""
    engines, _ = tier_engines(seed=5)
    q = np.random.default_rng(6).normal(0, 1, (64, 16)).astype(np.float32)
    return engines["f32"], q


def _frontend(eng, **cfg_kw):
    clock = FakeClock()
    defaults = dict(max_batch=8, max_wait_ms=2.0, max_queue=16)
    defaults.update(cfg_kw)
    fe = ServingFrontend(eng, FrontendConfig(**defaults), clock=clock)
    return fe, clock


# ------------------------------------------------------------------ flushes

def test_size_triggered_flush(tiny_engine):
    eng, q = tiny_engine
    fe, clock = _frontend(eng, max_batch=8)
    pends = [fe.submit(SearchRequest(queries=q[i])) for i in range(8)]
    # the 8th submit crossed max_batch: everything served, clock never moved
    assert all(p.done() for p in pends)
    assert clock() == 0.0
    assert fe.stats().batches == 1
    for p in pends:
        assert p.result().stats.batch_size == 8
        assert p.result().stats.queue_ms == 0.0


def test_deadline_triggered_flush(tiny_engine):
    eng, q = tiny_engine
    fe, clock = _frontend(eng, max_wait_ms=2.0)
    pends = [fe.submit(SearchRequest(queries=q[i])) for i in range(3)]
    assert not any(p.done() for p in pends)
    clock.advance(1.9e-3)
    assert fe.poll() == 0                   # deadline not reached yet
    assert fe.next_deadline() == pytest.approx(2.0e-3)
    clock.advance(0.2e-3)
    assert fe.poll() == 1                   # one coalesced serve call
    assert all(p.done() for p in pends)
    res = pends[0].result()
    assert res.stats.batch_size == 3
    assert res.stats.queue_ms == pytest.approx(2.1)


def test_per_request_deadline_tightens_window(tiny_engine):
    """deadline_ms is an SLO: the flush window becomes min(max_wait, SLO) —
    an urgent request pulls its group's flush forward, but a lax SLO never
    stretches the batching window beyond max_wait_ms."""
    eng, q = tiny_engine
    fe, clock = _frontend(eng, max_wait_ms=5.0)
    slow = fe.submit(SearchRequest(queries=q[0]))
    lax = fe.submit(SearchRequest(queries=q[2], deadline_ms=50.0))
    assert lax.flush_by == pytest.approx(5e-3)     # min() caps at max_wait
    fast = fe.submit(SearchRequest(queries=q[1], deadline_ms=0.5))
    assert fe.next_deadline() == pytest.approx(0.5e-3)
    clock.advance(0.6e-3)
    fe.poll()
    # the urgent deadline flushed its GROUP: all compatible requests rode
    # the same batch rather than splitting traffic
    assert fast.done() and slow.done() and lax.done()
    assert fast.result().stats.batch_size == 3


def test_result_demands_flush(tiny_engine):
    """A caller blocking on result() is itself a deadline — the group is
    flushed early instead of deadlocking a never-polled queue."""
    eng, q = tiny_engine
    fe, _ = _frontend(eng)
    p0 = fe.submit(SearchRequest(queries=q[0]))
    p1 = fe.submit(SearchRequest(queries=q[1]))
    assert not p0.done()
    res = p0.result()
    assert res.stats.batch_size == 2        # coalesced with the waiting peer
    assert p1.done()
    assert fe.depth() == 0


def test_allow_batching_false_bypasses_queue(tiny_engine):
    eng, q = tiny_engine
    fe, _ = _frontend(eng)
    queued = fe.submit(SearchRequest(queries=q[0]))
    solo = fe.submit(SearchRequest(queries=q[1], allow_batching=False))
    assert solo.done() and not queued.done()     # queue untouched
    assert solo.result().stats.batch_size == 1
    assert fe.depth() == 1


def test_bypass_request_with_expired_deadline_is_shed(tiny_engine):
    """allow_batching=False must not skip the dead-on-arrival check: a bypass
    request whose explicit deadline_ms already passed sheds with reason doa,
    exactly like the queued path — serving provably-late traffic burns drain
    capacity either way."""
    eng, q = tiny_engine
    fe, clock = _frontend(eng)
    clock.advance(1.0)
    doa = fe.submit(SearchRequest(queries=q[0], deadline_ms=1.0,
                                  allow_batching=False), t_arrival=0.0)
    assert doa.done()
    res = doa.result()
    assert res.stats.shed and res.stats.batch_size == 0
    # a live deadline still bypasses straight to a solo batch
    live = fe.submit(SearchRequest(queries=q[1], deadline_ms=1e4,
                                   allow_batching=False))
    assert live.done() and not live.result().stats.shed
    assert live.result().stats.batch_size == 1
    assert fe.depth() == 0


# ---------------------------------------------------------- bucket rounding

def test_size_trigger_rounds_into_jit_buckets(tiny_engine):
    """max_batch rounds up to the engine's pow2 jit-cache bucket, so size
    flushes always land on a compiled step with zero padding waste."""
    eng, q = tiny_engine
    fe, _ = _frontend(eng, max_batch=5)
    assert fe.max_batch == eng._batch_bucket(5) == 8
    pends = [fe.submit(SearchRequest(queries=q[i])) for i in range(8)]
    assert all(p.done() for p in pends)
    assert pends[0].result().stats.bucket == 8


def test_deadline_flush_bucket_matches_engine(tiny_engine):
    eng, q = tiny_engine
    fe, clock = _frontend(eng)
    pends = [fe.submit(SearchRequest(queries=q[i])) for i in range(3)]
    clock.advance(5e-3)
    fe.poll()
    # a 3-row deadline flush serves through the engine's 8-bucket
    assert pends[0].result().stats.bucket == eng._batch_bucket(3) == 8


# ----------------------------------------------------------- group splitting

def test_incompatible_requests_split_into_groups(tiny_engine):
    eng, q = tiny_engine
    fe, clock = _frontend(eng)
    a = fe.submit(SearchRequest(queries=q[0]))                  # defaults
    b = fe.submit(SearchRequest(queries=q[1], k=3))             # different k
    c = fe.submit(SearchRequest(queries=q[2], sigma=0.9))       # different σ
    d = fe.submit(SearchRequest(queries=q[3], tier="f32"))      # same (default)
    assert len(fe._groups) == 3
    clock.advance(5e-3)
    assert fe.poll() == 3                   # one serve call per group
    assert a.result().stats.batch_size == 2 and d.result().stats.batch_size == 2
    assert b.result().stats.batch_size == 1 and b.result().dists.shape[1] == 3
    assert c.result().stats.batch_size == 1
    assert c.result().stats.sigma == pytest.approx(0.9)


def test_alias_and_default_requests_coalesce(tiny_engine):
    """Tier aliases, impl="auto" and None must land in one group — they hit
    the same compiled step (mirrors serve_fn's cache-key normalization)."""
    eng, q = tiny_engine
    fe, _ = _frontend(eng)
    fe.submit(SearchRequest(queries=q[0]))
    fe.submit(SearchRequest(queries=q[1], tier="exact"))        # alias of f32
    fe.submit(SearchRequest(queries=q[2], tier="f32", impl="auto"))
    assert len(fe._groups) == 1


# ------------------------------------------------------- admission control

def test_admission_control_sheds_beyond_max_queue(tiny_engine):
    eng, q = tiny_engine
    fe, clock = _frontend(eng, max_queue=2, max_batch=64)
    admitted = [fe.submit(SearchRequest(queries=q[i])) for i in range(2)]
    shed = [fe.submit(SearchRequest(queries=q[2 + i])) for i in range(3)]
    for p in shed:                          # resolved immediately, marked shed
        assert p.done()
        res = p.result()
        assert res.stats.shed and res.stats.batch_size == 0
        assert (res.ids == -1).all() and not np.isfinite(res.dists).any()
        assert (res.nprobe_eff == 0).all()
    stats = fe.stats()
    assert stats.shed == 3 and stats.depth == 2
    clock.advance(5e-3)
    fe.poll()
    for p in admitted:                      # admitted traffic still correct
        assert not p.result().stats.shed
        assert p.result().stats.batch_size == 2
    assert fe.stats().served == 2


def test_priority_displaces_lower_priority_queued(tiny_engine):
    eng, q = tiny_engine
    fe, clock = _frontend(eng, max_queue=1, max_batch=64)
    low = fe.submit(SearchRequest(queries=q[0], priority=0))
    high = fe.submit(SearchRequest(queries=q[1], priority=1))
    # the queued low-priority request was shed to admit the newcomer
    assert low.done() and low.result().stats.shed
    assert not high.done()
    # an equal-priority newcomer is shed itself (no churn on ties)
    equal = fe.submit(SearchRequest(queries=q[2], priority=1))
    assert equal.done() and equal.result().stats.shed
    clock.advance(5e-3)
    fe.poll()
    assert not high.result().stats.shed


def test_priority_orders_oversized_group_flush(tiny_engine):
    """A group larger than max_batch rows (multi-row requests) flushes as
    several serve calls, higher-priority requests riding the first one."""
    eng, q = tiny_engine
    fe, _ = _frontend(eng, max_queue=64, max_batch=4)
    assert fe.max_batch == 8                # 4 rounds up to the 8-bucket
    low = fe.submit(SearchRequest(queries=q[:6], priority=0))   # 6 rows
    high = fe.submit(SearchRequest(queries=q[6:10], priority=1))  # 4 rows
    # 10 rows ≥ 8 triggered the flush: high went first and low no longer fit
    assert fe.stats().batches == 2 and fe.depth() == 0
    assert high.result().stats.batch_size == 4
    assert low.result().stats.batch_size == 6
    # multi-row scatter slices the right rows back per request
    for j in range(6):
        solo = eng.search(SearchRequest(queries=q[j:j + 1]))
        np.testing.assert_array_equal(low.result().dists[j], solo.dists[0])


# ------------------------------------------------------------- telemetry

def test_frontend_stats_quantiles_and_qps(tiny_engine):
    eng, q = tiny_engine
    fe, clock = _frontend(eng, max_wait_ms=1.0, max_batch=64)
    for wave in range(4):                   # 4 deadline flushes, 2 reqs each
        fe.submit(SearchRequest(queries=q[2 * wave]))
        fe.submit(SearchRequest(queries=q[2 * wave + 1]))
        clock.advance(1.1e-3)
        fe.poll()
    stats = fe.stats()
    assert stats.submitted == stats.served == 8
    assert stats.batches == 4 and stats.mean_batch == 2.0
    # every request waited exactly 1.1 virtual ms — degenerate quantiles
    assert stats.p50_ms == pytest.approx(1.1)
    assert stats.p99_ms == pytest.approx(1.1)
    # 8 queries over the 4.4ms span from first submit to last completion
    assert stats.qps == pytest.approx(8 / 4.4e-3, rel=1e-6)
    assert stats.depth == 0 and stats.shed == 0


def test_charged_service_time_lands_in_latency(tiny_engine):
    """charge_service couples measured engine wall time onto the virtual
    clock — latency telemetry then reflects real serve cost."""
    eng, q = tiny_engine
    clock = FakeClock()
    fe = ServingFrontend(
        eng, FrontendConfig(max_batch=8, max_wait_ms=2.0), clock=clock,
        charge_service=True)
    pends = [fe.submit(SearchRequest(queries=q[i])) for i in range(8)]
    assert clock() > 0.0                    # the serve call charged the clock
    assert pends[0].result().stats.queue_ms == 0.0
    assert fe.stats().p50_ms > 0.0


def test_charge_service_requires_advanceable_clock(tiny_engine):
    eng, _ = tiny_engine
    import time

    with pytest.raises(TypeError, match="advance"):
        ServingFrontend(eng, charge_service=True, clock=time.monotonic)
    fe = ServingFrontend(eng)               # wall clock, no charging: fine
    with pytest.raises(TypeError, match="advanceable"):
        simulate_open_loop(fe, np.zeros((1, 16), np.float32),
                           rate_qps=1.0, n_requests=1)


def test_fake_clock_monotonic():
    clock = FakeClock(10.0)
    assert clock() == 10.0
    clock.advance(0.5)
    assert clock() == 10.5
    with pytest.raises(ValueError, match="backwards"):
        clock.advance(-1.0)


def test_backdated_arrival_expired_deadline_is_shed(tiny_engine):
    """A backdated submit whose EXPLICIT deadline already passed is shed
    outright (dead on arrival) — serving provably-late traffic would burn
    drain capacity. Without an explicit deadline_ms there is no SLO to blow:
    a stale backdated submit still queues (merely late), and an on-time one
    queues with its true arrival driving queue_ms."""
    eng, q = tiny_engine
    fe, clock = _frontend(eng, max_wait_ms=2.0)
    clock.advance(10e-3)
    dead = fe.submit(SearchRequest(queries=q[0], deadline_ms=5.0),
                     t_arrival=0.0)
    assert dead.done() and dead.result().stats.shed
    # same staleness, no explicit SLO → admitted, not shed
    stale = fe.submit(SearchRequest(queries=q[2]), t_arrival=0.0)
    assert not stale.done()
    live = fe.submit(SearchRequest(queries=q[1]), t_arrival=9e-3)
    assert not live.done()
    assert live.flush_by == pytest.approx(11e-3)
    # the stale request's window expired long ago: next poll flushes both
    assert fe.poll() == 1
    assert stale.done() and live.done()
    # queue wait measured from the true arrival, not the submit call
    assert live.result().stats.queue_ms == pytest.approx(1.0)
    assert stale.result().stats.queue_ms == pytest.approx(10.0)


# ------------------------------------------------------------ open loop sim

def test_open_loop_low_load_sheds_nothing(tiny_engine):
    eng, q = tiny_engine
    clock = FakeClock()
    fe = ServingFrontend(eng, FrontendConfig(max_batch=8, max_wait_ms=2.0,
                                             max_queue=32), clock=clock)
    stats, pendings = simulate_open_loop(fe, q, rate_qps=2000.0, n_requests=40)
    assert stats.shed == 0 and stats.served == 40
    assert all(p.done() for p in pendings)
    # no service charging: every latency is pure queue wait ≤ the window
    assert stats.p99_ms <= 2.0 + 1e-9
    assert stats.depth == 0


def test_open_loop_overload_sheds_and_serves_rest(tiny_engine):
    eng, q = tiny_engine
    clock = FakeClock()
    fe = ServingFrontend(
        eng, FrontendConfig(max_batch=64, max_wait_ms=50.0, max_queue=8),
        clock=clock)
    # 30 arrivals inside one 50ms window with an 8-deep queue: exactly the
    # overflow beyond max_queue is shed, everything admitted still answers
    stats, pendings = simulate_open_loop(fe, q, rate_qps=10_000.0,
                                         n_requests=30)
    assert stats.shed > 0 and stats.served == 30 - stats.shed
    served = [p for p in pendings if not p.result().stats.shed]
    assert len(served) == stats.served
    for p in served:
        assert np.isfinite(p.result().dists[:, 0]).all()


# --------------------------------------------------- batched-vs-solo parity

N, NQ, DIM, B = 1200, 12, 16, 8


@pytest.fixture(scope="module")
def parity_engines():
    """One η > 0 build serving all three tiers: a pq engine and a residual_pq
    engine over its store with residual codes added."""
    ds = make_vector_dataset(n=N, n_queries=NQ, dim=DIM, n_modes=B, center_scale=8.0,
                             spread=0.5, boundary_frac=0.05, noise_frac=0.0, seed=33)
    eng = LiraEngine.build(ds.base, BuildConfig(n_partitions=B, k=10, eta=0.03,
                                                train_frac=0.5, epochs=2, nprobe_max=B,
                                                tier="pq", pq_m=4, pq_ks=32, rerank=4),
                           device="cpu")
    qs = build_quantized_store(eng.store["vectors"], eng.store["ids"], m=4, ks=eng.cfg.pq_ks,
                               residual=True, centroids=eng.store["centroids"],
                               generator=torch.Generator().manual_seed(9))
    store_r = {**eng.store, "codes": qs.codes, "codebooks": qs.codebooks, "cterm": qs.cterm}
    eng_r = LiraEngine(cfg=dataclasses.replace(eng.cfg, tier="residual_pq"), model=eng.model,
                       store=store_r, device=eng.device, sigma=eng.sigma)
    return eng, eng_r, ds


@pytest.mark.parametrize("tier", ["f32", "pq", "residual_pq"])
def test_coalesced_batch_bit_identical_to_solo(parity_engines, tier):
    """Rows scattered out of a coalesced batch equal solo ``search`` calls
    bit for bit: the batch serves through another bucket (12 → 16) and
    q_cap than the solo calls (1 → 8), so this pins the serve step's row
    independence."""
    eng, eng_r, ds = parity_engines
    engine = eng_r if tier == "residual_pq" else eng
    solo = [engine.search(SearchRequest(queries=ds.queries[i:i + 1], sigma=0.3, tier=tier))
            for i in range(NQ)]
    fe = ServingFrontend(engine, FrontendConfig(max_batch=16, max_wait_ms=1.0, max_queue=64),
                         clock=FakeClock())
    pends = [fe.submit(SearchRequest(queries=ds.queries[i], sigma=0.3, tier=tier))
             for i in range(NQ)]
    fe.drain()
    assert fe.stats().batches == 1
    for i, p in enumerate(pends):
        res = p.result()
        assert res.stats.batch_size == NQ and not res.stats.shed
        np.testing.assert_array_equal(res.dists, solo[i].dists, err_msg=str(i))
        np.testing.assert_array_equal(res.ids, solo[i].ids, err_msg=str(i))
        np.testing.assert_array_equal(res.nprobe_eff, solo[i].nprobe_eff)
        assert solo[i].overflow == 0        # parity precondition: no drops


def test_search_one_matches_search_with_and_without_frontend(parity_engines):
    eng, _, ds = parity_engines
    want = eng.search(SearchRequest(queries=ds.queries[:1], sigma=0.3))
    eng.frontend = None
    direct = eng.search_one(SearchRequest(queries=ds.queries[0], sigma=0.3))
    np.testing.assert_array_equal(direct.dists, want.dists)
    np.testing.assert_array_equal(direct.ids, want.ids)
    try:
        fe = eng.attach_frontend(FrontendConfig(max_batch=16), clock=FakeClock())
        routed = eng.search_one(SearchRequest(queries=ds.queries[0], sigma=0.3))
        assert fe.stats().submitted == 1    # went through the queue
        np.testing.assert_array_equal(routed.dists, want.dists)
        np.testing.assert_array_equal(routed.ids, want.ids)
        assert routed.stats.batch_size == 1
    finally:
        eng.frontend = None                 # module-scoped engine: detach


def test_search_one_rejects_batches_and_raw_arrays(parity_engines):
    eng, _, ds = parity_engines
    with pytest.raises(TypeError, match="SearchRequest"):
        eng.search_one(ds.queries[0])
    with pytest.raises(ValueError, match="exactly one query"):
        eng.search_one(SearchRequest(queries=ds.queries[:2]))


def test_unpadded_serve_step_matches_frontend_rows(tiny_engine):
    """A front-end-served row equals the bare serve step's row for the same
    batch (ties the scatter to make_serve_step, not only to search)."""
    eng, q = tiny_engine
    fe, _ = _frontend(eng, max_batch=8)
    pends = [fe.submit(SearchRequest(queries=q[i])) for i in range(8)]
    mesh = make_test_mesh(device="cpu")
    fn = make_serve_step(eng.cfg, 8, sigma=-1.0, impl="ref", k=eng.cfg.k, mesh=mesh)
    d, i, _, _, _ = fn(place_ranks(eng.model, eng.store, eng.cfg, mesh),
                       torch.from_numpy(q[:8]), torch.ones(8, dtype=torch.bool))
    for r, p in enumerate(pends):
        np.testing.assert_array_equal(p.result().dists[0], d[r].numpy())
        np.testing.assert_array_equal(p.result().ids[0], i[r].numpy())


# ------------------------------------------------------ epoch atomicity

def test_mutations_drain_frontend_and_swap_epochs_atomically():
    eng, cents, _ = raw_engine()
    clock = FakeClock()
    fe = eng.attach_frontend(FrontendConfig(max_batch=64, max_wait_ms=50.0), clock=clock)
    q = (cents[:3] + 0.01).astype(np.float32)
    pending = [fe.submit(SearchRequest(queries=q[i:i + 1])) for i in range(3)]
    assert not any(p.done() for p in pending)             # still coalescing
    eng.delete([2, 3])                                    # quiesces first
    for p in pending:                                     # served before the swap,
        res = p.result()
        assert res.stats.epoch == 0                       # wholly in epoch 0,
        assert res.stats.batch_size == 3                  # as one batch
    after = fe.submit(SearchRequest(queries=q[:1])).result()
    assert after.stats.epoch == 1                         # the bump, at once
    assert eng.epoch == 1
    # every kind of mutation drains first
    for mutate in (lambda: eng.insert(cents[:1] + 0.02, [900]), eng.compact,
                   lambda: eng.maybe_repartition(force=True)):
        epoch = eng.epoch
        p = fe.submit(SearchRequest(queries=q[:1]))
        mutate()
        assert p.done() and p.result().stats.epoch == epoch
        assert eng.epoch == epoch + 1


# ----------------------------------------------- against the JAX front-end

def _package(name):
    """The front-end's surface of one package: the JAX reference or the port."""
    if name == "jax":
        from repro.configs.base import FrontendConfig as Cfg
        from repro.serving import frontend as fe_mod
        from repro.serving.api import SearchRequest as Req
        from repro.utils.clock import FakeClock as Clock
    else:
        from repro_torch.configs.base import FrontendConfig as Cfg
        from repro_torch.serving import frontend as fe_mod
        from repro_torch.serving.api import SearchRequest as Req
        from repro_torch.utils.clock import FakeClock as Clock
    return dataclasses.make_dataclass("Package", ["Cfg", "Req", "Clock", "fe"])(
        Cfg, Req, Clock, fe_mod)


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    return jax_and_port(tmp_path_factory.mktemp("frontend-pair"))


def _drive_size_flush(p, eng, q):
    fe = p.fe.ServingFrontend(eng, p.Cfg(max_batch=8, max_wait_ms=2.0, max_queue=16),
                              clock=p.Clock())
    return fe, [fe.submit(p.Req(queries=q[i])) for i in range(8)]


def _drive_deadline_flush(p, eng, q):
    clock = p.Clock()
    fe = p.fe.ServingFrontend(eng, p.Cfg(max_batch=8, max_wait_ms=2.0), clock=clock)
    pends = [fe.submit(p.Req(queries=q[i])) for i in range(3)]
    clock.advance(1.9e-3)
    fe.poll()
    clock.advance(0.2e-3)
    fe.poll()
    return fe, pends


def _drive_request_deadlines(p, eng, q):
    clock = p.Clock()
    fe = p.fe.ServingFrontend(eng, p.Cfg(max_batch=16, max_wait_ms=5.0), clock=clock)
    pends = [fe.submit(p.Req(queries=q[0])),
             fe.submit(p.Req(queries=q[2], deadline_ms=50.0))]
    clock.advance(0.1e-3)
    pends.append(fe.submit(p.Req(queries=q[1], deadline_ms=0.5)))
    clock.advance(0.6e-3)
    fe.poll()
    pends.append(fe.submit(p.Req(queries=q[3], deadline_ms=1.0)))
    clock.advance(1.5e-3)
    fe.poll()
    return fe, pends


def _drive_result_flush_and_bypass(p, eng, q):
    clock = p.Clock()
    fe = p.fe.ServingFrontend(eng, p.Cfg(max_batch=8, max_wait_ms=2.0), clock=clock)
    pends = [fe.submit(p.Req(queries=q[i])) for i in range(2)]
    clock.advance(0.3e-3)
    pends[0].result()
    queued = fe.submit(p.Req(queries=q[2]))
    clock.advance(1.0)
    pends += [queued,
              fe.submit(p.Req(queries=q[3], deadline_ms=1.0, allow_batching=False),
                        t_arrival=0.0),
              fe.submit(p.Req(queries=q[4], deadline_ms=1e4, allow_batching=False))]
    fe.drain()
    return fe, pends


def _drive_groups(p, eng, q):
    clock = p.Clock()
    fe = p.fe.ServingFrontend(eng, p.Cfg(max_batch=8, max_wait_ms=2.0), clock=clock)
    pends = [fe.submit(p.Req(queries=q[0])),
             fe.submit(p.Req(queries=q[1], k=3)),
             fe.submit(p.Req(queries=q[2], sigma=0.9)),
             fe.submit(p.Req(queries=q[3], tier="f32")),
             fe.submit(p.Req(queries=q[4], tier="exact")),
             fe.submit(p.Req(queries=q[5], tier="residual_pq"))]
    clock.advance(5e-3)
    fe.poll()
    return fe, pends


def _drive_admission(p, eng, q):
    clock = p.Clock()
    fe = p.fe.ServingFrontend(eng, p.Cfg(max_batch=64, max_wait_ms=2.0, max_queue=2),
                              clock=clock)
    pends = [fe.submit(p.Req(queries=q[i])) for i in range(5)]
    clock.advance(5e-3)
    fe.poll()
    return fe, pends


def _drive_priorities(p, eng, q):
    clock = p.Clock()
    fe = p.fe.ServingFrontend(eng, p.Cfg(max_batch=64, max_wait_ms=2.0, max_queue=2),
                              clock=clock)
    pends = [fe.submit(p.Req(queries=q[0], priority=0)),
             fe.submit(p.Req(queries=q[1], priority=2)),
             fe.submit(p.Req(queries=q[2], priority=1)),
             fe.submit(p.Req(queries=q[3], priority=1)),
             fe.submit(p.Req(queries=q[4], priority=3))]
    clock.advance(5e-3)
    fe.poll()
    fe2 = p.fe.ServingFrontend(eng, p.Cfg(max_batch=4, max_wait_ms=2.0, max_queue=64),
                               clock=p.Clock())
    pends += [fe2.submit(p.Req(queries=q[:6], priority=0)),
              fe2.submit(p.Req(queries=q[6:10], priority=1))]
    # equal-priority victims across groups: the newest goes first
    clock3 = p.Clock()
    fe3 = p.fe.ServingFrontend(eng, p.Cfg(max_batch=64, max_wait_ms=2.0, max_queue=3),
                               clock=clock3)
    pends += [fe3.submit(p.Req(queries=q[10], priority=0)),
              fe3.submit(p.Req(queries=q[11], priority=0, k=3)),
              fe3.submit(p.Req(queries=q[12], priority=0)),
              fe3.submit(p.Req(queries=q[13], priority=1)),
              fe3.submit(p.Req(queries=q[14], priority=1, k=3))]
    clock3.advance(5e-3)
    fe3.poll()
    return fe, pends


def _drive_backdated(p, eng, q):
    clock = p.Clock()
    fe = p.fe.ServingFrontend(eng, p.Cfg(max_batch=8, max_wait_ms=2.0), clock=clock)
    clock.advance(10e-3)
    pends = [fe.submit(p.Req(queries=q[0], deadline_ms=5.0), t_arrival=0.0),
             fe.submit(p.Req(queries=q[2]), t_arrival=0.0),
             fe.submit(p.Req(queries=q[1]), t_arrival=9e-3)]
    fe.poll()
    return fe, pends


def _drive_waves(p, eng, q):
    clock = p.Clock()
    fe = p.fe.ServingFrontend(eng, p.Cfg(max_batch=64, max_wait_ms=1.0), clock=clock)
    pends = []
    for wave in range(5):       # deadline flushes of 1 to 5 requests, unequal waits
        for i in range(wave + 1):
            pends.append(fe.submit(p.Req(queries=q[(wave + i) % len(q)])))
            clock.advance(0.13e-3 * (i + 1))
        clock.advance(1.1e-3)
        fe.poll()
    return fe, pends


def _drive_open_loop(rate_qps, n_requests, cfg_kw, **sim_kw):
    def drive(p, eng, q):
        fe = p.fe.ServingFrontend(eng, p.Cfg(**cfg_kw), clock=p.Clock())
        _, pends = p.fe.simulate_open_loop(fe, q, rate_qps=rate_qps,
                                           n_requests=n_requests, **sim_kw)
        return fe, pends
    return drive


TRACES = {
    "size flush": _drive_size_flush,
    "deadline flush": _drive_deadline_flush,
    "request deadlines": _drive_request_deadlines,
    "result flush and bypass": _drive_result_flush_and_bypass,
    "compatibility groups": _drive_groups,
    "admission": _drive_admission,
    "priorities": _drive_priorities,
    "backdated arrivals": _drive_backdated,
    "quantile waves": _drive_waves,
    "open loop low load": _drive_open_loop(
        2000.0, 40, dict(max_batch=8, max_wait_ms=2.0, max_queue=32)),
    "open loop overload": _drive_open_loop(
        10_000.0, 30, dict(max_batch=64, max_wait_ms=50.0, max_queue=8)),
    "open loop with deadlines": _drive_open_loop(
        5_000.0, 48, dict(max_batch=16, max_wait_ms=4.0, max_queue=6),
        deadline_ms=3.0, priority=1, sigma=0.4, k=7),
}


@pytest.mark.parametrize("trace", list(TRACES))
def test_frontend_trace_matches_jax(jax_pair, trace):
    """The JAX front-end and the port's take one request trace on a FakeClock
    each (no service charging, so time is the trace's alone): equal
    FrontendStats and queue depth, and for each request equal scheduling
    (shed, batch_size, bucket, queue_ms, latency_ms, k, σ, tier, epoch) and
    answers under the parity contract of ``tests/test_torch_engine.py``."""
    engines, q = jax_pair
    runs = {name: TRACES[trace](_package(name), engines[name], q) for name in engines}
    (jfe, jpends), (tfe, tpends) = runs["jax"], runs["torch"]
    assert dataclasses.asdict(tfe.stats()) == dataclasses.asdict(jfe.stats())
    assert tfe.depth() == jfe.depth() == 0
    assert len(tpends) == len(jpends)
    atol = rt.l2_atol(q, engines["torch"].store["vectors"], engines["torch"].store["ids"])
    fields = ("shed", "batch_size", "bucket", "queue_ms", "latency_ms", "k", "sigma",
              "tier", "epoch")
    for i, (jp, tp) in enumerate(zip(jpends, tpends)):
        jr, tr = jp.result(), tp.result()
        for f in fields:
            assert getattr(tr.stats, f) == getattr(jr.stats, f), (trace, i, f)
        np.testing.assert_array_equal(tr.nprobe_eff, np.asarray(jr.nprobe_eff))
        assert tr.overflow == jr.overflow
        if jr.stats.shed:
            np.testing.assert_array_equal(tr.ids, jr.ids)
            np.testing.assert_array_equal(tr.dists, jr.dists)
        else:
            rt.assert_topk_match(tr.dists, tr.ids, jr.dists, jr.ids, atol,
                                 what=f"{trace} request {i}")
