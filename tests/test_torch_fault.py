"""The port's replica-group policies (``repro_torch.distributed.fault``) held
against the reference's (``repro.distributed.fault``): each scenario of the
reference's own tests runs on both packages, under one seed and a
``FakeClock`` of each, with its assertions, and both must end in the same
state: every pick, served count, in-flight depth, heartbeat stamp, latency
EWMA and hedge, and every failover / hedge counter in the metrics registry.
"""
import types

import pytest

import repro.distributed.fault as jax_fault
import repro.obs as jax_obs
import repro.utils.clock as jax_clock
import repro_torch.distributed.fault as torch_fault
import repro_torch.obs as torch_obs
import repro_torch.utils.clock as torch_clock

PACKAGES = {
    "jax": types.SimpleNamespace(fault=jax_fault, Registry=jax_obs.MetricsRegistry,
                                 FakeClock=jax_clock.FakeClock),
    "torch": types.SimpleNamespace(fault=torch_fault, Registry=torch_obs.MetricsRegistry,
                                   FakeClock=torch_clock.FakeClock),
}
COUNTERS = ("lira_failovers_total", "lira_hedges_total", "lira_hedge_wins_total")


def state(router, reg=None, *extra):
    """Everything a scenario leaves behind, as plain values."""
    out = [[(r.rid, r.healthy, r.inflight, r.served, r.latency_scale, r.ewma,
             r.last_heartbeat) for r in router.replicas], router.requeued, *extra]
    if reg is not None:
        out.append([reg.counter(n).total() for n in COUNTERS])
    return out


def router_of(p, n, seed, *, clock=None, metrics=None):
    """A ReplicaRouter of package ``p`` on a FakeClock and a fresh registry
    unless given."""
    return p.fault.ReplicaRouter(n, seed=seed,
                                 clock=clock if clock is not None else p.FakeClock(),
                                 metrics=metrics if metrics is not None else p.Registry())


def warm(mit, n=30, latency=1.0):
    for _ in range(n):
        mit.serve(latency)


# ---------------------------------------------------------------- routing

def pick_prefers_lower_inflight_of_two_choices(p):
    router = router_of(p, 2, 0)
    router.replicas[0].inflight = 10
    picks = [router.pick().rid for _ in range(50)]
    assert picks == [1] * 50
    return state(router, None, picks)


def pick_single_healthy_replica_needs_no_sampling(p):
    router = router_of(p, 3, 1)
    router.mark_failed(0)
    router.mark_failed(2)
    picks = [router.pick().rid for _ in range(10)]
    assert picks == [1] * 10
    return state(router, None, picks)


def pick_with_no_healthy_replicas_raises(p):
    router = router_of(p, 2, 0)
    router.mark_failed(0)
    router.mark_failed(1)
    with pytest.raises(RuntimeError, match="no healthy replicas"):
        router.pick()
    return state(router)


def pick_is_deterministic_under_seed(p):
    ra = router_of(p, 8, 7)
    rb = router_of(p, 8, 7)
    picks = [ra.pick().rid for _ in range(32)]
    assert picks == [rb.pick().rid for _ in range(32)]
    return picks


def pick_spreads_load_across_equal_replicas(p):
    router = router_of(p, 4, 3)
    picks = [router.pick().rid for _ in range(200)]
    assert set(picks) == {0, 1, 2, 3}
    return picks


# --------------------------------------------------------------- failover

def mark_failed_requeues_inflight_and_recover_rejoins(p):
    reg = p.Registry()
    router = router_of(p, 3, 0, metrics=reg)
    router.replicas[1].inflight = 4
    lost = router.mark_failed(1)
    assert lost == 4 and router.requeued == 4
    assert router.replicas[1].inflight == 0 and not router.replicas[1].healthy
    assert [r.rid for r in router.healthy()] == [0, 2]
    router.recover(1)
    assert [r.rid for r in router.healthy()] == [0, 1, 2]
    assert router.mark_failed(1) == 0 and router.requeued == 4
    return state(router, reg)


def dispatch_serves_every_batch_exactly_once(p):
    router = router_of(p, 4, 11)
    served = router.dispatch(100)
    assert sum(served.values()) == 100 and router.requeued == 0
    return state(router, None, served)


def dispatch_mid_flight_failure_replays_on_healthy_replica(p):
    reg = p.Registry()
    router = router_of(p, 3, 5, metrics=reg)
    served = router.dispatch(60, fail_at=(30, 2))
    assert sum(served.values()) == 60 and router.requeued == 1
    assert not router.replicas[2].healthy
    assert served[2] == router.replicas[2].served and served[0] + served[1] >= 30
    return state(router, reg, served)


def dispatch_failure_spec_is_idempotent_after_death(p):
    router = router_of(p, 2, 9)
    served = router.dispatch(10, fail_at=(0, 0))
    assert sum(served.values()) == 10 and router.requeued == 1 and served[1] == 10
    return state(router, None, served)


# ---------------------------------------------------------------- hedging

def straggler_hedge_caps_tail_latency(p):
    reg = p.Registry()
    router = router_of(p, 3, 2, metrics=reg)
    mit = p.fault.StragglerMitigator(router, hedge_factor=3.0)
    warm(mit, 30, 1.0)
    router.replicas[0].latency_scale = 100.0
    lats = [mit.serve(1.0) for _ in range(200)]
    assert mit.hedges > 0 and max(lats) <= 3.0 * 1.0 + 1.0 + 1e-9
    return state(router, reg, lats, mit.hedges, mit.hedge_wins)


def no_hedging_before_history_warmup(p):
    router = router_of(p, 2, 4)
    router.replicas[0].latency_scale = 50.0
    mit = p.fault.StragglerMitigator(router)
    lats = [mit.serve(1.0) for _ in range(19)]
    assert mit.hedges == 0 and any(lat == 50.0 for lat in lats)
    return state(router, None, lats)


def hedge_prefers_best_ewma_replica(p):
    router = router_of(p, 3, 6)
    mit = p.fault.StragglerMitigator(router, hedge_factor=2.0)
    warm(mit, 25, 1.0)
    router.replicas[0].latency_scale = 40.0
    router.replicas[1].ewma = 5.0
    router.replicas[2].ewma = 0.5
    for _ in range(100):
        mit.serve(1.0)
    assert mit.hedges > 0 and router.replicas[2].ewma > 0.5
    return state(router, None, mit.hedges, mit.latencies)


def hedging_deterministic_under_seed(p):
    def run():
        router = router_of(p, 4, 13)
        router.replicas[3].latency_scale = 30.0
        mit = p.fault.StragglerMitigator(router)
        warm(mit, 20, 1.0)
        return [mit.serve(1.0) for _ in range(100)], mit.hedges

    a, b = run(), run()
    assert a == b
    return a


def replica_dataclass_defaults(p):
    r = p.fault.Replica(rid=7)
    assert (r.healthy, r.inflight, r.served, r.latency_scale) == (True, 0, 0, 1.0)
    return [r.rid, r.healthy, r.inflight, r.served, r.latency_scale, r.ewma, r.last_heartbeat]


# --------------------------------------------------------- real dispatch

def route_replays_inflight_batch_on_replica_failure(p):
    reg = p.Registry()
    router = router_of(p, 2, 0, metrics=reg)
    doomed = {0}

    def fn(r):
        if r.rid in doomed:
            doomed.discard(r.rid)
            raise p.fault.ReplicaFailure("connection lost mid-serve")
        return ("answer", r.rid)

    results = [router.route(fn) for _ in range(6)]
    assert all(out == ("answer", r.rid) for out, r in results)
    assert router.requeued == 1 and not router.replicas[0].healthy
    assert all(r.rid == 1 for _, r in results)
    assert reg.counter("lira_failovers_total").total() == 1.0
    assert reg.gauge("lira_replica_inflight").value(shard="default", replica="1") == 0.0
    return state(router, reg, [r.rid for _, r in results])


def call_stamps_heartbeat_and_check_heartbeats_fails_stale(p):
    clock = p.FakeClock()
    router = router_of(p, 2, 0, clock=clock)
    clock.advance(3.0)
    router.call(router.replicas[0], lambda r: "ok")
    assert router.replicas[0].last_heartbeat == 3.0
    clock.advance(4.0)
    failed = router.check_heartbeats(timeout_s=5.0)
    assert failed == [(1, 0)] and not router.replicas[1].healthy
    assert router.replicas[0].healthy
    router.recover(1)
    assert router.replicas[1].last_heartbeat == clock()
    return state(router, None, failed)


def _hedged_run(p, fn):
    reg = p.Registry()
    router = router_of(p, 2, 0, metrics=reg)
    router.replicas[1].inflight = 1      # the straggler is drawn as primary
    mit = p.fault.StragglerMitigator(router, hedge_factor=3.0)
    mit.latencies.extend([1.0] * 20)
    result, winner, eff, hedged = mit.run(lambda r: fn(p, r))
    return router, reg, mit, (result, winner.rid, eff, hedged, mit.hedges, mit.hedge_wins)


def mitigator_run_hedge_first_response_wins(p):
    router, reg, mit, out = _hedged_run(
        p, lambda p, r: (f"from{r.rid}", 9.0 if r.rid == 0 else 1.0))
    assert out == ("from1", 1, pytest.approx(4.0), True, 1, 1)
    assert reg.counter("lira_hedge_wins_total").total() == 1.0
    return state(router, reg, out)


def mitigator_run_slow_hedge_is_discounted(p):
    router, reg, mit, out = _hedged_run(
        p, lambda p, r: (f"from{r.rid}", 9.0 if r.rid == 0 else 50.0))
    assert out == ("from0", 0, pytest.approx(9.0), True, 1, 0)
    return state(router, reg, out)


def mitigator_run_dead_hedge_keeps_primary_answer(p):
    def fn(p, r):
        if r.rid == 1:
            raise p.fault.ReplicaFailure("hedge target died")
        return ("primary", 9.0)

    router, reg, mit, out = _hedged_run(p, fn)
    assert out[:2] == ("primary", 0) and out[3] and not router.replicas[1].healthy
    return state(router, reg, out)


def mitigator_warmup_is_configurable(p):
    router = router_of(p, 2, 4)
    mit = p.fault.StragglerMitigator(router, warmup=5)
    for _ in range(5):
        mit.serve(1.0)
    router.replicas[0].latency_scale = 50.0
    lats = [mit.serve(1.0) for _ in range(30)]
    assert mit.hedges > 0 and max(lats) < 50.0
    return state(router, None, lats)


SCENARIOS = {f.__name__: f for f in (
    pick_prefers_lower_inflight_of_two_choices, pick_single_healthy_replica_needs_no_sampling,
    pick_with_no_healthy_replicas_raises, pick_is_deterministic_under_seed,
    pick_spreads_load_across_equal_replicas, mark_failed_requeues_inflight_and_recover_rejoins,
    dispatch_serves_every_batch_exactly_once,
    dispatch_mid_flight_failure_replays_on_healthy_replica,
    dispatch_failure_spec_is_idempotent_after_death, straggler_hedge_caps_tail_latency,
    no_hedging_before_history_warmup, hedge_prefers_best_ewma_replica,
    hedging_deterministic_under_seed, replica_dataclass_defaults,
    route_replays_inflight_batch_on_replica_failure,
    call_stamps_heartbeat_and_check_heartbeats_fails_stale,
    mitigator_run_hedge_first_response_wins, mitigator_run_slow_hedge_is_discounted,
    mitigator_run_dead_hedge_keeps_primary_answer, mitigator_warmup_is_configurable)}


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_port_policy_matches_reference(scenario):
    run = SCENARIOS[scenario]
    assert run(PACKAGES["torch"]) == run(PACKAGES["jax"])


def test_port_metrics_land_in_the_ports_registry():
    """The port's series are its own registry's (never ``repro.obs``'s)."""
    reg = torch_obs.MetricsRegistry()
    router = torch_fault.ReplicaRouter(2, seed=0, clock=torch_clock.FakeClock(), metrics=reg,
                                       name="shard3")
    router.replicas[0].inflight = 2
    router.mark_failed(0)
    assert reg.counter("lira_failovers_total").value(shard="shard3") == 2.0
    assert reg.gauge("lira_replica_healthy").value(shard="shard3", replica="0") == 0.0
    default = torch_fault.ReplicaRouter(1, seed=0)
    assert default._m() is torch_obs.default_registry()
