"""Cluster serving: LANNS-style two-level sharding × replica groups
(counterpart of ``repro/serving/cluster.py``).

One ``LiraEngine`` serves one partition mesh. Larger corpora exceed it
(LANNS, arxiv 2010.09426), and heavy traffic exceeds one replica (HARMONY,
arxiv 2506.14707), so the topology is a ``LiraCluster``:

    LiraCluster
      ├── shard 0  (level-1 LANNS shard: its own k-means, probing model,
      │            tier store over its slice of the corpus)
      │     ├── replica 0 ─┐  ReplicaRouter: power-of-two-choices on
      │     └── replica 1 ─┘  in-flight depth, heartbeat failover
      ├── shard 1
      │     ├── replica 0 ─┐  StragglerMitigator: hedged dispatch,
      │     └── replica 1 ─┘  first response wins
      └── cross-shard top-k merge (dedup_topk's host twin)

**Sharding** happens at build time (``plan_shards``, the reference's numpy
arithmetic and RNG, so the plans are equal): ``hash`` spreads rows by a
multiplicative hash of their global id (LANNS's random sharder, balanced by
construction); ``kmeans`` clusters rows into S coarse groups under a balance
cap (LANNS's clustered sharder; the cluster still fans out to every shard,
so answers stay exact). Each shard is a full engine build over its rows,
with a local→global id map beside it.

**Serving** fans a query batch to every shard group. Within a group the
router picks a live replica and the mitigator hedges stragglers: when the
primary's measured service exceeds 3× the median history, the batch
re-issues to the best-EWMA sibling and the first completion wins. Replicas
of a shard serve the same engine, so only latency depends on the winner. A
replica that dies mid-serve (``ReplicaFailure``) has its in-flight batch
replayed on a healthy sibling, and a silently stalled replica is failed by
heartbeat timeout at the next ``tick()``: no batch is lost either way.

**Merge** pools the S per-shard top-k lists (global ids) and reduces them
with ``kernels.ref.dedup_topk_np``, the host twin of the serve step's merge
(selection by (dist, id), duplicate ids collapsed to their best distance),
as the reference does. The kernels the cluster runs are those inside each
shard's engine.

**Exactness.** Per-shard answers are exact over each shard's rows when the
scan is (σ = -1 fans out to every partition; for the PQ tiers a shortlist
that covers the partition, rerank·k ≥ capacity), and the global top-k of a
union lies in the union of the per-shard top-k lists: the merged answer
then equals an engine built over the union corpus up to the rounding of its
distances (each engine's L2 expansion uses its own ‖c‖² and probing
distances), under ``repro_torch.testing``'s comparison rule.

Time is injectable (``clock`` for heartbeats and failover,
``service_timer`` for measured service; ``fixed_service_s`` replaces the
measurement for deterministic policy tests), so the failover story runs
under ``repro_torch.utils.clock.FakeClock`` with no sleeps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.distributed.fault import ReplicaFailure, ReplicaRouter, StragglerMitigator
from repro_torch.kernels.ref import dedup_topk_np
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import api, tiers
from repro_torch.serving.engine import LiraEngine

__all__ = ["ClusterConfig", "LiraCluster", "ShardPlan", "plan_shards"]


# ---------------------------------------------------------------- sharding

@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Level-1 shard assignment: which coarse shard owns each row."""

    mode: str                       # "hash" | "kmeans"
    n_shards: int
    assign: np.ndarray              # [n] shard index per row
    centroids: Optional[np.ndarray] = None  # [S, dim] (kmeans mode only)


def _hash_shard(ids: np.ndarray, n_shards: int) -> np.ndarray:
    """Content-independent Fibonacci hash of the global id — LANNS's random
    sharder: balanced in expectation, stable under re-build."""
    h = (ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(32)
    return (h % np.uint64(n_shards)).astype(np.int32)


def plan_shards(x: np.ndarray, n_shards: int, *, mode: str = "hash",
                ids: Optional[np.ndarray] = None, seed: int = 0,
                balance_slack: float = 1.2, iters: int = 10) -> ShardPlan:
    """LANNS-style level-1 sharding of ``x`` into ``n_shards`` coarse shards.

    ``hash`` ignores geometry (ids hashed, balanced in expectation);
    ``kmeans`` runs a small numpy Lloyd's over the rows and assigns each row
    to its nearest shard centroid subject to a balance cap of
    ``ceil(n / S · balance_slack)`` rows — overflowing rows spill to their
    next-nearest shard with space, so no shard engine build degenerates."""
    n = len(x)
    if not 1 <= n_shards <= n:
        raise ValueError(f"n_shards={n_shards} must be in [1, {n}]")
    ids = np.arange(n, dtype=np.int64) if ids is None else np.asarray(ids)
    if mode == "hash":
        return ShardPlan("hash", n_shards, _hash_shard(ids, n_shards))
    if mode != "kmeans":
        raise ValueError(f"unknown shard mode {mode!r}; expected hash|kmeans")
    rng = np.random.default_rng(seed)
    xf = np.asarray(x, np.float32)
    cents = xf[rng.choice(n, n_shards, replace=False)].copy()
    for _ in range(iters):
        d2 = ((xf * xf).sum(1)[:, None] - 2.0 * xf @ cents.T
              + (cents * cents).sum(1)[None, :])
        a = d2.argmin(1)
        for s in range(n_shards):
            m = a == s
            if m.any():
                cents[s] = xf[m].mean(0)
    # balanced greedy assignment: rows in a seeded random order take their
    # nearest shard with remaining capacity (spill to next-nearest)
    d2 = ((xf * xf).sum(1)[:, None] - 2.0 * xf @ cents.T
          + (cents * cents).sum(1)[None, :])
    prefs = np.argsort(d2, axis=1)
    cap = int(np.ceil(n / n_shards * balance_slack))
    left = np.full(n_shards, cap, np.int64)
    assign = np.empty(n, np.int32)
    for row in rng.permutation(n):
        for s in prefs[row]:
            if left[s] > 0:
                assign[row] = s
                left[s] -= 1
                break
        else:  # caps sum to ≥ n·slack > n, so space always exists somewhere
            raise AssertionError("balance caps exhausted")
    return ShardPlan("kmeans", n_shards, assign, centroids=cents)


# ----------------------------------------------------------------- cluster

@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Topology + control-plane policy for a ``LiraCluster``."""

    n_shards: int = 2               # level-1 LANNS shards (S)
    n_replicas: int = 2             # replicas per shard group (R)
    shard_mode: str = "hash"        # plan_shards mode: hash | kmeans
    hedging: bool = True            # hedge stragglers via StragglerMitigator
    hedge_factor: float = 3.0       # deadline = factor × median history
    hedge_warmup: int = 20          # history before hedging may fire
    heartbeat_timeout_s: float = 10.0  # tick() fails replicas staler than this
    seed: int = 0


@dataclasses.dataclass
class ShardReplica:
    """Control-plane wrapper for one replica of one shard. Replicas of a
    shard share the shard's built engine (same store, bit-identical answers);
    what differs is health, load and fault injection."""

    sid: int
    rid: int
    engine: LiraEngine
    armed_failure: bool = False     # next dispatch raises ReplicaFailure
    stalled: bool = False           # stops heartbeating (silent stall)
    busy_s: float = 0.0             # effective service charged to this replica


@dataclasses.dataclass
class ShardGroup:
    """One level-1 shard: the engine, its local→global id map, and the
    replica-group control plane."""

    sid: int
    engine: LiraEngine
    row_ids: np.ndarray             # [n_shard] local store id → global id
    router: ReplicaRouter
    mitigator: StragglerMitigator
    members: list


def _dup_count_np(ids_pool: np.ndarray) -> int:
    """Duplicate valid ids in the cross-shard candidate pool (what the merge
    collapses) — the cluster-level mirror of the engine's dedup_hits."""
    i = np.sort(np.asarray(ids_pool, np.int64), axis=1)
    return int(((i[:, 1:] == i[:, :-1]) & (i[:, 1:] >= 0)).sum())


class LiraCluster:
    """S coarse shards × R replicas per shard over a union corpus, served
    scatter-gather with routed/hedged/failover-replayed dispatch and an exact
    cross-shard merge. Duck-types the engine surface the serving front-end
    needs (``search``/``search_one``/``_batch_bucket``/``attach_frontend``),
    so ``ServingFrontend`` batches single-query traffic onto a cluster
    exactly as onto one engine."""

    def __init__(self, engines: list, row_ids: list, config: ClusterConfig
                 | None = None, *, plan: Optional[ShardPlan] = None,
                 clock: Optional[Callable[[], float]] = None,
                 charge_service: bool = False,
                 service_timer: Callable[[], float] = time.perf_counter,
                 fixed_service_s: Optional[float] = None,
                 tracer=None, metrics=None):
        if len(engines) != len(row_ids) or not engines:
            raise ValueError("need one row_ids map per engine (≥1 shard)")
        ccfg = config if config is not None else ClusterConfig(
            n_shards=len(engines))
        if ccfg.n_shards != len(engines):
            raise ValueError(f"config says {ccfg.n_shards} shards, "
                             f"got {len(engines)} engines")
        self.ccfg = ccfg
        self.plan = plan
        self.clock = clock if clock is not None else time.monotonic
        if charge_service and not hasattr(self.clock, "advance"):
            raise TypeError("charge_service=True needs a clock with .advance "
                            "(e.g. FakeClock)")
        self.charge_service = charge_service
        self.service_timer = service_timer
        self.fixed_service_s = fixed_service_s
        self.tracer = tracer
        self.metrics = metrics
        self.frontend = None
        self.groups: list[ShardGroup] = []
        for s, (eng, rmap) in enumerate(zip(engines, row_ids)):
            router = ReplicaRouter(
                ccfg.n_replicas, seed=ccfg.seed + s, clock=self.clock,
                metrics=metrics, name=f"shard{s}")
            self.groups.append(ShardGroup(
                sid=s, engine=eng, row_ids=np.asarray(rmap, np.int32),
                router=router,
                mitigator=StragglerMitigator(
                    router, hedge_factor=ccfg.hedge_factor,
                    warmup=ccfg.hedge_warmup),
                members=[ShardReplica(sid=s, rid=r, engine=eng)
                         for r in range(ccfg.n_replicas)]))

    # ------------------------------------------------------------ build

    @classmethod
    def build(cls, x: np.ndarray, config: api.BuildConfig,
              cluster: ClusterConfig | None = None, *,
              ids: Optional[np.ndarray] = None, device=None, mesh=None,
              **kwargs) -> "LiraCluster":
        """Shard ``x`` per the cluster config (LANNS level 1), build one full
        engine per shard (its own k-means, probing model and tier store,
        seeded per shard) on ``device`` and ``mesh`` (as
        ``LiraEngine.build``), and wire the replica-group control plane.
        ``ids`` are the global point ids (default ``arange``); each shard
        keeps the local→global map so merged answers speak global ids. Extra
        kwargs go to ``LiraCluster.__init__`` (clock, metrics, tracer, ...)."""
        ccfg = cluster if cluster is not None else ClusterConfig()
        n = len(x)
        gids = (np.arange(n, dtype=np.int64) if ids is None
                else np.asarray(ids, np.int64))
        plan = plan_shards(x, ccfg.n_shards, mode=ccfg.shard_mode, ids=gids,
                           seed=ccfg.seed)
        engines, row_ids = [], []
        for s in range(ccfg.n_shards):
            rows = np.flatnonzero(plan.assign == s)
            engines.append(LiraEngine.build(
                x[rows], dataclasses.replace(config, seed=config.seed + s),
                device=device, mesh=mesh))
            row_ids.append(gids[rows])
        return cls(engines, row_ids, ccfg, plan=plan, **kwargs)

    # ---------------------------------------------------- engine duck-typing

    @property
    def cfg(self):
        return self.groups[0].engine.cfg

    @property
    def sigma(self) -> float:
        return self.groups[0].engine.sigma

    def _batch_bucket(self, nq: int) -> int:
        return self.groups[0].engine._batch_bucket(nq)

    def resolve_impl(self, impl=None) -> str:
        return self.groups[0].engine.resolve_impl(impl)

    def _tracer(self):
        return self.tracer if self.tracer is not None else obs_trace.NOOP

    def _registry(self) -> obs_metrics.MetricsRegistry:
        return (self.metrics if self.metrics is not None
                else obs_metrics.default_registry())

    def search_one(self, request: api.SearchRequest) -> api.SearchResult:
        """Single-query entry, mirroring ``LiraEngine.search_one``: routes
        through the attached front-end (dynamic batching) when present."""
        if not isinstance(request, api.SearchRequest):
            raise TypeError("search_one takes a SearchRequest; for raw query "
                            "batches use search()")
        q = np.asarray(request.queries)
        if q.ndim == 1:
            request = dataclasses.replace(request, queries=q[None, :])
        elif q.ndim != 2 or q.shape[0] != 1:
            raise ValueError("search_one serves exactly one query "
                             f"(got shape {q.shape}); use search() for batches")
        if self.frontend is not None:
            return self.frontend.submit(request).result()
        return self.search(request)

    def attach_frontend(self, config=None, **kwargs):
        """Attach a ``ServingFrontend`` over the whole cluster — the
        front-end routing hook: coalesced batches fan out to every shard
        group through the routed/hedged dispatch path. Detach with
        ``cluster.frontend = None``."""
        from repro_torch.serving.frontend import ServingFrontend

        self.frontend = ServingFrontend(self, config, **kwargs)
        return self.frontend

    # -------------------------------------------------------- fault control

    def _member(self, shard: int, rid: int) -> ShardReplica:
        return self.groups[shard].members[rid]

    def fail_replica(self, shard: int, rid: int, *,
                     inflight: bool = False) -> None:
        """Fault injection. ``inflight=False`` fails the replica between
        batches (clean heartbeat loss); ``inflight=True`` arms a one-shot
        mid-serve failure — the NEXT batch routed to it raises
        ``ReplicaFailure`` with the batch in flight, exercising the re-queue
        + replay path."""
        if inflight:
            self._member(shard, rid).armed_failure = True
        else:
            self.groups[shard].router.mark_failed(rid)

    def stall_replica(self, shard: int, rid: int) -> None:
        """Silent stall: the replica stops heartbeating (but never errors);
        ``tick()`` fails it once ``heartbeat_timeout_s`` passes on the
        injected clock — the detection path crash failures skip."""
        self._member(shard, rid).stalled = True

    def recover_replica(self, shard: int, rid: int) -> None:
        m = self._member(shard, rid)
        m.armed_failure = m.stalled = False
        self.groups[shard].router.recover(rid)

    def tick(self) -> list[tuple[int, int, int]]:
        """Heartbeat pass, run before every search (and callable as the
        deployment's liveness prober): live, non-stalled replicas stamp their
        heartbeat; replicas staler than ``heartbeat_timeout_s`` are failed
        and their in-flight batches re-queued. Returns
        ``[(shard, rid, lost), ...]`` for newly failed replicas."""
        failed = []
        for g in self.groups:
            for m, pol in zip(g.members, g.router.replicas):
                if pol.healthy and not m.stalled:
                    g.router.heartbeat(m.rid)
            failed.extend((g.sid, rid, lost) for rid, lost in
                          g.router.check_heartbeats(
                              self.ccfg.heartbeat_timeout_s))
        return failed

    # -------------------------------------------------------------- serving

    def _resolve(self, req: api.SearchRequest):
        """Resolve per-call overrides against shard 0's config (all shards
        are built from one BuildConfig, so any shard works), mirroring
        ``ServingFrontend._resolve_key``."""
        eng = self.groups[0].engine
        k = eng.cfg.k if req.k is None else int(req.k)
        sigma = float(eng.sigma if req.sigma is None else req.sigma)
        tier = tiers.resolve(req.tier if req.tier is not None
                             else eng.cfg.tier).name
        return k, sigma, tier, self.resolve_impl(req.impl)

    def _dispatch_shard(self, g: ShardGroup, req: api.SearchRequest, tr):
        """Serve one shard group: route → (optionally) hedge → failover
        replay. Returns (SearchResult, winner rid, effective service_s,
        hedged, failovers)."""
        requeued0 = g.router.requeued

        def fn(pol):
            m = g.members[pol.rid]
            if m.armed_failure:
                m.armed_failure = False  # one-shot: the batch dies in flight
                raise ReplicaFailure(
                    f"shard {g.sid} replica {pol.rid} died mid-serve")
            t0 = self.service_timer()
            res = m.engine.search(req)
            meas = (self.service_timer() - t0 if self.fixed_service_s is None
                    else self.fixed_service_s)
            return res, meas * pol.latency_scale

        with tr.span("cluster.shard", shard=g.sid):
            if self.ccfg.hedging:
                res, winner, eff, hedged = g.mitigator.run(fn)
            else:
                (res, eff), winner = g.router.route(fn)
                hedged = False
        g.members[winner.rid].busy_s += eff
        failovers = g.router.requeued - requeued0
        self._registry().counter(
            "lira_cluster_replica_served_total",
            "batches served, by winning replica").inc(
                shard=str(g.sid), replica=str(winner.rid))
        return res, winner.rid, float(eff), hedged, failovers

    def search(self, queries, *, sigma: Optional[float] = None,
               tier: Optional[str] = None, impl: Optional[str] = None,
               k: Optional[int] = None) -> api.SearchResult:
        """Serve one query batch across every shard and merge. ``queries``
        is an [nq, dim] array or a ``SearchRequest`` (then no keyword
        overrides). The merged result speaks global ids;
        ``stats.routes`` records ``(shard, replica, hedged, failovers)`` per
        shard, ``stats.latency_ms`` the effective cluster service time — the
        max over shard groups, since shards are parallel pods (hedging
        already folded in)."""
        if isinstance(queries, api.SearchRequest):
            if any(a is not None for a in (sigma, tier, impl, k)):
                raise TypeError(
                    "pass either a SearchRequest or keyword overrides, not both")
            req = queries
        else:
            req = api.SearchRequest(queries=np.asarray(queries), k=k,
                                    sigma=sigma, tier=tier, impl=impl)
        q = np.asarray(req.queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        k_res, sigma_res, tier_res, impl_res = self._resolve(req)
        shard_req = api.SearchRequest(queries=q, k=k_res, sigma=sigma_res,
                                      tier=tier_res, impl=impl_res)
        self.tick()
        tr = self._tracer()
        outs = []
        with tr.span("cluster.search", shards=len(self.groups),
                     rows=q.shape[0]) as sp_root:
            for g in self.groups:
                res, rid, eff, hedged, failovers = self._dispatch_shard(
                    g, shard_req, tr)
                loc = res.ids
                gid = np.where(loc >= 0,
                               g.row_ids[np.clip(loc, 0, None)],
                               np.int32(-1))
                outs.append((g.sid, res, gid, rid, eff, hedged, failovers))
            with tr.span("cluster.merge"):
                pool_d = np.concatenate([o[1].dists for o in outs], axis=1)
                pool_i = np.concatenate([o[2] for o in outs], axis=1)
                cross_dups = _dup_count_np(pool_i)
                dists, ids = dedup_topk_np(pool_d, pool_i, k_res)
            sp_root.set(tier=tier_res, impl=impl_res)

        eff_cluster = max(o[4] for o in outs)  # shards serve in parallel pods
        if self.charge_service:
            self.clock.advance(eff_cluster)
        routes = tuple((o[0], o[3], o[5], o[6]) for o in outs)
        nprobe_eff = np.sum([o[1].nprobe_eff for o in outs], axis=0)
        overflow = sum(o[1].overflow for o in outs)
        dedup_hits = sum(o[1].stats.dedup_hits for o in outs) + cross_dups

        lbl = {"tier": tier_res, "impl": impl_res}
        m = self._registry()
        m.counter("lira_cluster_searches_total",
                  "cluster.search calls").inc(**lbl)
        m.counter("lira_cluster_rows_total",
                  "query rows served by the cluster").inc(q.shape[0], **lbl)
        m.counter("lira_cluster_merge_dedup_hits_total",
                  "duplicate ids collapsed by the cross-shard merge").inc(
                      cross_dups, **lbl)

        return api.SearchResult(
            dists=dists, ids=ids, nprobe_eff=nprobe_eff, overflow=overflow,
            stats=api.SearchStats(
                tier=tier_res, impl=impl_res, k=k_res, sigma=sigma_res,
                bucket=outs[0][1].stats.bucket,
                cache_hit=all(o[1].stats.cache_hit for o in outs),
                dedup_hits=dedup_hits, latency_ms=eff_cluster * 1e3,
                epoch=max(o[1].stats.epoch for o in outs),
                hedged=any(o[5] for o in outs),
                failovers=sum(o[6] for o in outs),
                routes=routes))

    # ------------------------------------------------------------ telemetry

    def replica_table(self) -> list[dict]:
        """Control-plane snapshot: one row per (shard, replica) with health,
        load and effective busy time — what the launcher prints."""
        return [{"shard": g.sid, "replica": pol.rid, "healthy": pol.healthy,
                 "served": pol.served, "ewma": pol.ewma,
                 "busy_s": m.busy_s, "stalled": m.stalled}
                for g in self.groups
                for m, pol in zip(g.members, g.router.replicas)]
