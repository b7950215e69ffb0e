"""Failure and straggler policies for replica groups (counterpart of
``repro/distributed/fault.py``): host Python, shared by
``serving/cluster.py``'s replica groups and runnable as a pure simulation
(``dispatch`` / ``serve``), so the policies are testable without a card.

  * ReplicaRouter — power-of-two-choices load balancing over healthy
    replicas, heartbeat-based failure detection (``check_heartbeats``
    against an injectable clock), failover and re-queue of a dead replica's
    in-flight batches. ``route(fn)`` drives a real dispatch callable: a
    ``ReplicaFailure`` raised mid-serve fails the replica and replays the
    in-flight batch on a healthy sibling, so no batch is lost;
  * StragglerMitigator — hedged requests: when the primary exceeds the
    hedge deadline (3× the median history), the batch is re-issued to the
    healthy replica with the best latency EWMA and the first response wins.
    ``run(fn)`` is the real-dispatch form, ``serve(base_latency)`` the
    synthetic-latency simulation.

``requeued`` and ``hedges`` are cheap mirrors; the series live in the
port's metrics registry (``obs/metrics.py``), labeled ``shard=<router
name>`` (and ``replica=`` where per replica):

  * ``lira_failovers_total``     — in-flight batches replayed off dead replicas
  * ``lira_hedges_total``        — hedge requests issued
  * ``lira_hedge_wins_total``    — hedges that beat the primary
  * ``lira_replica_inflight``    — per-replica in-flight gauge
  * ``lira_replica_healthy``     — per-replica liveness gauge (1/0)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.obs import metrics as obs_metrics


class ReplicaFailure(RuntimeError):
    """Raised by a dispatch callable when its replica dies mid-serve
    (connection loss / heartbeat timeout with the batch in flight). The
    router treats it as a failure event: the replica is failed, its
    in-flight batch re-queued and replayed on a healthy sibling."""


@dataclasses.dataclass
class Replica:
    rid: int
    healthy: bool = True
    inflight: int = 0
    served: int = 0
    latency_scale: float = 1.0     # >1 = straggler
    ewma: float = 1.0              # latency EWMA (hedge target selection)
    last_heartbeat: float = 0.0    # injectable-clock stamp of last liveness


class ReplicaRouter:
    """Routing + failover policy for one replica group.

    ``clock`` is any zero-arg callable returning seconds (``time.monotonic``
    in production, ``repro_torch.utils.clock.FakeClock`` in tests); heartbeats are
    stamped against it. ``metrics`` is an obs registry (None → the
    process-wide default); series are labeled ``shard=<name>`` so several
    groups (one per cluster shard) sharing a registry never mix."""

    def __init__(self, n_replicas: int, seed: int = 0, *,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None, name: str = "default"):
        self.clock = clock if clock is not None else time.monotonic
        self.metrics = metrics
        self.name = name
        self._lbl = {"shard": name}
        self.replicas = [Replica(i, last_heartbeat=self.clock())
                         for i in range(n_replicas)]
        self.rng = np.random.default_rng(seed)
        self.requeued = 0

    def _m(self) -> obs_metrics.MetricsRegistry:
        return (self.metrics if self.metrics is not None
                else obs_metrics.default_registry())

    def _g_inflight(self):
        return self._m().gauge("lira_replica_inflight",
                               "in-flight batches per replica")

    def _g_healthy(self):
        return self._m().gauge("lira_replica_healthy",
                               "replica liveness (1 healthy, 0 failed)")

    def _c_failovers(self):
        return self._m().counter(
            "lira_failovers_total",
            "in-flight batches replayed off failed replicas")

    def healthy(self):
        return [r for r in self.replicas if r.healthy]

    def pick(self) -> Replica:
        """Power-of-two-choices on in-flight depth."""
        h = self.healthy()
        if not h:
            raise RuntimeError("no healthy replicas")
        if len(h) == 1:
            return h[0]
        a, b = self.rng.choice(len(h), 2, replace=False)
        return h[a] if h[a].inflight <= h[b].inflight else h[b]

    def mark_failed(self, rid: int) -> int:
        """Heartbeat loss: fail the replica, re-queue its in-flight batches.
        Returns number of batches to replay."""
        r = self.replicas[rid]
        r.healthy = False
        lost = r.inflight
        r.inflight = 0
        self.requeued += lost
        self._c_failovers().inc(lost, **self._lbl)
        self._g_inflight().set(0, replica=str(rid), **self._lbl)
        self._g_healthy().set(0, replica=str(rid), **self._lbl)
        return lost

    def recover(self, rid: int):
        r = self.replicas[rid]
        r.healthy = True
        r.last_heartbeat = self.clock()
        self._g_healthy().set(1, replica=str(rid), **self._lbl)

    # ------------------------------------------------------------ heartbeats

    def heartbeat(self, rid: int) -> None:
        """Stamp replica liveness at the injected clock's now (successful
        serves do this implicitly via ``call``)."""
        self.replicas[rid].last_heartbeat = self.clock()

    def check_heartbeats(self, timeout_s: float) -> list[tuple[int, int]]:
        """Fail every healthy replica whose last heartbeat is older than
        ``timeout_s`` — the detection half of failover for replicas that
        stall silently instead of erroring. Returns ``[(rid, lost), ...]``
        for the newly failed (lost = in-flight batches re-queued)."""
        now = self.clock()
        return [(r.rid, self.mark_failed(r.rid)) for r in self.replicas
                if r.healthy and now - r.last_heartbeat > timeout_s]

    # --------------------------------------------------------- real dispatch

    def call(self, r: Replica, fn: Callable[[Replica], object]):
        """Run one dispatch on a specific replica with in-flight accounting:
        ``fn(r)`` executes with the batch counted in flight, so a
        ``ReplicaFailure`` mid-serve re-queues it (``mark_failed`` collects
        in-flight) before re-raising to the caller's replay loop. Success
        stamps the replica's heartbeat."""
        r.inflight += 1
        self._g_inflight().set(r.inflight, replica=str(r.rid), **self._lbl)
        try:
            out = fn(r)
        except ReplicaFailure:
            self.mark_failed(r.rid)
            raise
        r.inflight -= 1
        self._g_inflight().set(r.inflight, replica=str(r.rid), **self._lbl)
        r.served += 1
        r.last_heartbeat = self.clock()
        return out

    def route(self, fn: Callable[[Replica], object]):
        """Failover-transparent dispatch: pick a live replica by
        power-of-two-choices and run ``fn`` on it; on ``ReplicaFailure`` the
        batch (re-queued by ``call``/``mark_failed``) is replayed on the
        remaining healthy replicas. Raises RuntimeError("no healthy
        replicas") only when the whole group is dead. Returns
        ``(fn's result, serving replica)``."""
        while True:
            r = self.pick()
            try:
                return self.call(r, fn), r
            except ReplicaFailure:
                continue  # in-flight batch was re-queued: replay elsewhere

    # ----------------------------------------------------------- simulation

    def dispatch(self, n_batches: int, fail_at: Optional[tuple[int, int]] = None):
        """Simulate dispatching batches; fail_at=(batch_idx, rid) kills that
        replica WITH the batch in flight — the batch is re-queued and served
        by a healthy replica. Returns per-replica served counts (every batch
        is served exactly once)."""
        from collections import deque

        pending = deque(range(n_batches))
        while pending:
            i = pending.popleft()
            if fail_at is not None and i == fail_at[0] and self.replicas[fail_at[1]].healthy:
                victim = self.replicas[fail_at[1]]
                victim.inflight += 1          # batch lands on the doomed node
                self.mark_failed(victim.rid)  # heartbeat loss mid-serve
                pending.appendleft(i)         # replay on a healthy replica
                continue
            r = self.pick()
            r.served += 1
        return {r.rid: r.served for r in self.replicas}


class StragglerMitigator:
    """Hedged requests: if the primary exceeds a robust deadline (3× median —
    median is robust to a slow-node-polluted history), the batch is re-issued
    to the healthy replica with the best latency EWMA and the first response
    wins (tail-at-scale hedging). ``run`` drives real dispatch callables;
    ``serve`` is the synthetic-latency simulation form."""

    def __init__(self, router: ReplicaRouter, hedge_factor: float = 3.0,
                 warmup: int = 20):
        self.router = router
        self.hedge_factor = hedge_factor
        self.warmup = warmup
        self.latencies: list[float] = []
        self.hedges = 0
        self.hedge_wins = 0

    def _c_hedges(self):
        return self.router._m().counter("lira_hedges_total",
                                        "hedge requests issued")

    def _c_hedge_wins(self):
        return self.router._m().counter("lira_hedge_wins_total",
                                        "hedges that beat the primary")

    def deadline(self) -> Optional[float]:
        """Current hedge deadline, or None while the latency history is
        shorter than ``warmup`` (hedging on a cold median would misfire)."""
        if len(self.latencies) < self.warmup:
            return None
        return self.hedge_factor * float(np.median(self.latencies))

    def _hedge_target(self, primary: Replica) -> Optional[Replica]:
        others = [x for x in self.router.healthy() if x.rid != primary.rid]
        return min(others, key=lambda x: x.ewma) if others else None

    # --------------------------------------------------------- real dispatch

    def run(self, fn: Callable[[Replica], tuple]):
        """Hedged real dispatch. ``fn(replica) -> (result, service_s)`` serves
        one batch on one replica and reports its service time; replica
        failures raise ``ReplicaFailure`` (the router's ``route`` replays
        them). When the primary's service exceeds the hedge deadline, the
        batch is re-issued to the best-EWMA healthy sibling: the earlier
        completion (primary at ``service``, hedge at ``deadline + service2``)
        wins and the loser is discounted — with bit-identical replicas only
        latency, never the answer, depends on the winner. Returns
        ``(result, winner replica, effective service_s, hedged)``."""
        (result, lat), r = self.router.route(fn)
        winner, eff, hedged = r, float(lat), False
        deadline = self.deadline()
        if deadline is not None and eff > deadline:
            r2 = self._hedge_target(r)
            if r2 is not None:
                hedged = True
                self.hedges += 1
                self._c_hedges().inc(**self.router._lbl)
                try:
                    res2, lat2 = self.router.call(r2, fn)
                except ReplicaFailure:
                    pass  # hedge died; the primary's answer stands
                else:
                    r2.ewma = 0.9 * r2.ewma + 0.1 * float(lat2)
                    if deadline + float(lat2) < eff:
                        winner, result = r2, res2
                        eff = deadline + float(lat2)
                        self.hedge_wins += 1
                        self._c_hedge_wins().inc(**self.router._lbl)
        r.ewma = 0.9 * r.ewma + 0.1 * float(lat)
        self.latencies.append(eff)
        return result, winner, eff, hedged

    # ----------------------------------------------------------- simulation

    def serve(self, base_latency: float) -> float:
        r = self.router.pick()
        lat = base_latency * r.latency_scale
        deadline = self.deadline()
        if deadline is not None and lat > deadline:
            r2 = self._hedge_target(r)
            if r2 is not None:
                lat2 = deadline + base_latency * r2.latency_scale
                if lat2 < lat:
                    self.hedge_wins += 1
                    self._c_hedge_wins().inc(**self.router._lbl)
                lat = min(lat, lat2)
                r2.ewma = 0.9 * r2.ewma + 0.1 * (base_latency * r2.latency_scale)
                self.hedges += 1
                self._c_hedges().inc(**self.router._lbl)
        r.ewma = 0.9 * r.ewma + 0.1 * (base_latency * r.latency_scale)
        self.latencies.append(lat)
        r.served += 1
        return lat
