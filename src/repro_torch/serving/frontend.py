"""Online serving front-end: dynamic batching, admission control, telemetry
(counterpart of ``repro/serving/frontend.py``).

The engine underneath serves whole batches; traffic is a stream of
single-query ``SearchRequest``s. ``ServingFrontend`` is the layer between:

  * **dynamic batching**: requests wait per compatibility group (resolved
    ``(k, σ, tier, impl)``; incompatible requests never share a serve step)
    and flush on whichever trigger fires first: size (``max_batch`` rows,
    rounded up to the engine's power-of-two batch bucket) or deadline
    (``max_wait_ms`` since enqueue, tightened per request by
    ``SearchRequest.deadline_ms``, which also arms dead-on-arrival expiry);
  * **admission control**: a bounded queue (``max_queue`` requests). Beyond
    it load is shed: the lowest-priority waiting request (or the newcomer, if
    nothing queued outranks it) resolves at once with an empty answer marked
    ``SearchStats.shed=True``;
  * **latency telemetry**: every served request records its queue wait and
    end-to-end latency against the injected clock into log-spaced histograms
    of a metrics registry (``obs/metrics.py``), labeled ``frontend=<name>``.
    ``stats()`` snapshots p50/p99, QPS, shed/served counts and the mean
    coalesced batch as a ``FrontendStats``. With a tracer attached each
    served request's ``SearchStats.stages`` carries the queue → assemble →
    serve.* breakdown.

Each coalesced batch's rows are sliced back into per-request
``SearchResult``s. The serve step is row-independent, so on the CPU they are
bit-identical to a solo ``engine.search()`` of the same query (the tests hold
this for every tier); on the card the probing MLP's matmul may pick another
algorithm for another batch size, so there they agree under
``repro_torch.testing``'s rule. The one shared field is ``overflow``: q_cap
drops are counted per serve step, so a batched result reports its batch's.

The scheduler never sleeps or reads the wall clock on its own: time comes
from an injectable ``clock`` (``utils.clock.FakeClock`` for deterministic
tests and simulation, ``time.monotonic`` in production). The engine call is
synchronous, so flushes happen inside ``submit`` (size trigger), ``poll``
(deadline trigger: drivers call it as their event-loop tick) or
``PendingSearch.result()`` (a caller demanding its answer flushes its group).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.base import FrontendConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import api, tiers

__all__ = ["FrontendConfig", "FrontendStats", "PendingSearch", "ServingFrontend",
           "simulate_open_loop"]


@dataclasses.dataclass(frozen=True)
class FrontendStats:
    """Telemetry snapshot (``ServingFrontend.stats()``), read back from the
    metrics registry. Latency quantiles are bucket-interpolated from the
    cumulative ``lira_frontend_latency_ms`` histogram (clamped to the exact
    observed min/max, so degenerate distributions report exactly); QPS is
    served rows over the first-submit → last-completion span, reported only
    once ≥ 2 requests completed (a single completion has no span to divide
    by, so it reads 0.0 instead of a garbage rate)."""

    submitted: int                  # requests accepted into the front-end
    served: int                     # requests answered (excludes shed)
    shed: int                       # requests dropped by admission control
    batches: int                    # engine serve calls issued
    depth: int                      # requests currently queued
    mean_batch: float               # mean coalesced rows per serve call
    p50_ms: float                   # median end-to-end latency
    p99_ms: float                   # tail latency
    qps: float                      # served query rows / observed span


@dataclasses.dataclass
class PendingSearch:
    """Handle returned by ``submit``: resolves to a per-request SearchResult
    once its batch is served (or immediately, when shed). ``result()`` on a
    still-queued request force-flushes its group — demanding an answer is
    itself a deadline."""

    request: api.SearchRequest
    _frontend: "ServingFrontend" = dataclasses.field(repr=False)
    key: tuple = ()
    rows: int = 1
    seq: int = 0
    t_enq: float = 0.0
    flush_by: float = 0.0
    expire_at: Optional[float] = None       # explicit deadline_ms SLO, else None
    _result: Optional[api.SearchResult] = dataclasses.field(
        default=None, repr=False)

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> api.SearchResult:
        if self._result is None:
            self._frontend._flush_group(self.key)
        assert self._result is not None
        return self._result


_FE_NAMES = itertools.count()


class ServingFrontend:
    """Dynamic-batching request queue in front of one ``LiraEngine``.

    ``clock`` is any zero-arg callable returning seconds. With
    ``charge_service=True`` the wall time of each engine call (measured by
    ``service_timer``) is charged onto the clock via ``clock.advance`` — how
    the open-loop simulation keeps deterministic arrivals while latencies
    still reflect real serve cost.

    Telemetry lives in a metrics registry (``metrics=``, defaulting to the
    engine's) under ``lira_frontend_*`` series labeled ``frontend=<name>``;
    the name is auto-generated per instance so several front-ends sharing the
    process-wide default registry never mix their distributions. ``tracer=``
    (defaulting to the engine's) spans each batch: ``frontend.batch`` over
    ``frontend.assemble``, the engine's ``engine.*`` spans and
    ``frontend.scatter``.
    """

    def __init__(self, engine, config: FrontendConfig | None = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 charge_service: bool = False,
                 service_timer: Callable[[], float] = time.perf_counter,
                 tracer=None, metrics=None, name: Optional[str] = None):
        self.engine = engine
        self.cfg = config if config is not None else FrontendConfig()
        if charge_service and not hasattr(clock, "advance"):
            raise TypeError("charge_service=True needs a clock with .advance "
                            "(e.g. FakeClock)")
        self.clock = clock
        self.charge_service = charge_service
        self.service_timer = service_timer
        self.tracer = tracer
        self.metrics = metrics
        self.name = name if name is not None else f"fe{next(_FE_NAMES)}"
        self._lbl = {"frontend": self.name}
        # flush sizes land on whole buckets: round the size trigger up into
        # the engine's power-of-two batch buckets (engine.py:_batch_bucket)
        self.max_batch = int(engine._batch_bucket(self.cfg.max_batch))
        self._groups: dict[tuple, list[PendingSearch]] = {}
        self._seq = 0
        self._t_first: Optional[float] = None
        self._t_last_done: Optional[float] = None

    def _tr(self):
        return self.tracer if self.tracer is not None else self.engine._tracer()

    def _m(self) -> obs_metrics.MetricsRegistry:
        return (self.metrics if self.metrics is not None
                else self.engine._registry())

    # registry instruments (get-or-create is idempotent and cheap)
    def _c_submitted(self):
        return self._m().counter("lira_frontend_submitted_total",
                                 "requests accepted into the front-end")

    def _c_served(self):
        return self._m().counter("lira_frontend_served_total",
                                 "requests answered (excludes shed)")

    def _c_shed(self):
        return self._m().counter("lira_frontend_shed_total",
                                 "requests dropped, by reason: doa (deadline "
                                 "blown before enqueue), displaced (evicted "
                                 "by higher priority), rejected (full queue, "
                                 "nothing outranked)")

    def _c_batches(self):
        return self._m().counter("lira_frontend_batches_total",
                                 "engine serve calls issued")

    def _c_rows(self):
        return self._m().counter("lira_frontend_rows_total",
                                 "query rows served through batches")

    def _h_latency(self):
        return self._m().histogram("lira_frontend_latency_ms",
                                   "end-to-end request latency (injected "
                                   "clock)")

    def _h_queue(self):
        return self._m().histogram("lira_frontend_queue_ms",
                                   "enqueue → batch-launch wait")

    def _h_batch_rows(self):
        return self._m().histogram(
            "lira_frontend_batch_rows",
            "coalesced rows per serve call, per compatibility group",
            buckets=obs_metrics.BATCH_ROWS_BUCKETS)

    def _h_stage(self):
        return self._m().histogram("lira_frontend_stage_ms",
                                   "per-stage serve latency (traced runs "
                                   "only), labeled stage=assemble/serve.*/"
                                   "scatter")

    # ------------------------------------------------------------- intake

    def _resolve_key(self, req: api.SearchRequest) -> tuple:
        """Canonical compatibility key. Mirrors ``engine.serve_fn``'s
        normalization (tier aliases, impl="auto" resolved for the devices of
        the engine's ranks, k/σ=None) so requests that would share a
        serve-cache entry coalesce into the same group."""
        eng = self.engine
        k = eng.cfg.k if req.k is None else int(req.k)
        sigma = float(eng.sigma if req.sigma is None else req.sigma)
        tier = tiers.resolve(req.tier if req.tier is not None else eng.cfg.tier).name
        return (k, sigma, tier, eng.resolve_impl(req.impl))

    @staticmethod
    def _rows(req: api.SearchRequest) -> np.ndarray:
        q = np.asarray(req.queries)
        return q[None, :] if q.ndim == 1 else q

    def depth(self) -> int:
        """Requests currently queued (the admission-control measure)."""
        return sum(len(g) for g in self._groups.values())

    def submit(self, request: api.SearchRequest, *,
               t_arrival: Optional[float] = None) -> PendingSearch:
        """Enqueue one request; returns its handle. Size-triggered flushes run
        inline; sheds resolve the handle immediately with ``stats.shed=True``.

        ``t_arrival`` backdates the request to its true arrival time (the
        open-loop simulation uses this when intake lags behind the clock):
        queue wait and the flush deadline then measure from arrival.

        ``deadline_ms`` is an SLO, not just a flush hint: it tightens the
        flush trigger to ``min(max_wait_ms, deadline_ms)`` AND arms expiry —
        a request whose explicit deadline already passed before it could be
        enqueued is shed outright (dead on arrival), because serving
        provably-late traffic would only burn drain capacity the on-time
        queue needs. Requests without an explicit deadline never expire: the
        default ``max_wait_ms`` window is a batching knob, and an admitted
        request is always answered, merely late, when the engine falls
        behind."""
        key = self._resolve_key(request)
        now = self.clock()
        t_enq = now if t_arrival is None else float(t_arrival)
        wait_s = self.cfg.max_wait_ms / 1e3
        expire_at = None
        if request.deadline_ms is not None:
            slo_s = float(request.deadline_ms) / 1e3
            wait_s = min(wait_s, slo_s)
            expire_at = t_enq + slo_s
        self._seq += 1
        pending = PendingSearch(request=request, _frontend=self, key=key,
                                rows=len(self._rows(request)), seq=self._seq,
                                t_enq=t_enq, flush_by=t_enq + wait_s,
                                expire_at=expire_at)
        self._c_submitted().inc(**self._lbl)
        if self._t_first is None:
            self._t_first = t_enq
        if pending.expire_at is not None and pending.expire_at < now:
            # dead on arrival: SLO already blown. Checked BEFORE the bypass
            # branch — an allow_batching=False request with an expired
            # explicit deadline sheds exactly like the queued path would.
            self._shed(pending, "doa")
            return pending
        if not request.allow_batching:
            # bypass the queue entirely: a solo batch, served now
            self._serve_batch(key, [pending])
            return pending
        if self.depth() >= self.cfg.max_queue and not self._admit(pending):
            return pending
        self._groups.setdefault(key, []).append(pending)
        if sum(p.rows for p in self._groups[key]) >= self.max_batch:
            self._flush_group(key)
        return pending

    def _admit(self, pending: PendingSearch) -> bool:
        """Admission control at a full queue: shed the lowest-priority waiting
        request if the newcomer outranks it (newest victim on ties), else shed
        the newcomer. Returns True when ``pending`` was admitted."""
        victim = min((p for g in self._groups.values() for p in g),
                     key=lambda p: (p.request.priority, -p.seq), default=None)
        if victim is not None and victim.request.priority < pending.request.priority:
            # remove by identity: dataclass == on PendingSearch would compare
            # the numpy query arrays inside the requests (ambiguous truth)
            group = self._groups[victim.key]
            group[:] = [p for p in group if p is not victim]
            if not group:
                del self._groups[victim.key]
            self._shed(victim, "displaced")
            return True
        self._shed(pending, "rejected")
        return False

    def _shed(self, pending: PendingSearch, reason: str) -> None:
        k, sigma, tier, impl = pending.key
        pending._result = api.SearchResult(
            dists=np.full((pending.rows, k), np.inf, np.float32),
            ids=np.full((pending.rows, k), -1, np.int32),
            nprobe_eff=np.zeros((pending.rows,), np.float32), overflow=0,
            stats=api.SearchStats(tier=tier, impl=impl, k=k, sigma=sigma,
                                  bucket=0, cache_hit=False, queue_ms=0.0,
                                  batch_size=0, shed=True))
        self._c_shed().inc(reason=reason, **self._lbl)

    # ---------------------------------------------------------- scheduling

    def next_deadline(self) -> Optional[float]:
        """Earliest flush_by over queued requests (drivers poll() by then)."""
        deadlines = [p.flush_by for g in self._groups.values() for p in g]
        return min(deadlines) if deadlines else None

    def poll(self) -> int:
        """Deadline tick: flush every group whose earliest deadline has
        passed. Returns the number of serve calls issued."""
        now = self.clock()
        n = 0
        for key in list(self._groups):
            group = self._groups.get(key)
            if group and min(p.flush_by for p in group) <= now:
                n += self._flush_group(key)
        return n

    def drain(self) -> int:
        """Flush everything regardless of deadlines (shutdown / end of
        stream). Returns the number of serve calls issued."""
        return sum(self._flush_group(key) for key in list(self._groups))

    def quiesce(self) -> int:
        """Epoch barrier for store mutations (``LiraEngine.insert/delete/
        compact/maybe_repartition`` call this before touching the store):
        drain every queued request so no coalesced batch spans two epochs —
        everything in flight is served against the pre-mutation store and
        carries its ``SearchStats.epoch``; requests submitted afterwards see
        the bumped epoch atomically. Returns the serve calls issued."""
        return self.drain()

    def _flush_group(self, key: tuple) -> int:
        """Serve one group's queue: highest-priority first, at most
        ``max_batch`` coalesced rows per engine call."""
        group = self._groups.pop(key, None)
        if not group:
            return 0
        group.sort(key=lambda p: (-p.request.priority, p.seq))
        n_calls = 0
        while group:
            batch = [group.pop(0)]
            rows = batch[0].rows
            while group and rows + group[0].rows <= self.max_batch:
                pending = group.pop(0)
                batch.append(pending)
                rows += pending.rows
            self._serve_batch(key, batch)
            n_calls += 1
        return n_calls

    def _serve_batch(self, key: tuple, batch: list[PendingSearch]) -> None:
        k, sigma, tier, impl = key
        tr = self._tr()
        t_launch = self.clock()
        with tr.span("frontend.batch", group=str(key),
                     requests=len(batch)) as sp_batch:
            with tr.span("frontend.assemble") as sp_asm:
                queries = np.concatenate(
                    [self._rows(p.request) for p in batch], 0)
            t0 = self.service_timer()
            # engine.search opens its own engine.* spans, which nest under
            # frontend.batch when engine and front-end share a tracer
            res = self.engine.search(api.SearchRequest(
                queries=queries, k=k, sigma=sigma, tier=tier, impl=impl))
            if self.charge_service:
                self.clock.advance(self.service_timer() - t0)
            t_done = self.clock()
            with tr.span("frontend.scatter") as sp_scat:
                row = 0
                for pending in batch:
                    sl = slice(row, row + pending.rows)
                    row += pending.rows
                    queue_ms = (t_launch - pending.t_enq) * 1e3
                    latency_ms = (t_done - pending.t_enq) * 1e3
                    stages = None
                    if tr.enabled:
                        # per-request breakdown: queue wait is this request's
                        # own; assemble + engine stages are the batch's (each
                        # request in a batch experienced them once, together)
                        stages = {"queue": queue_ms,
                                  "assemble": sp_asm.duration_ms}
                        for st, ms in (res.stats.stages or {}).items():
                            stages[f"serve.{st}"] = ms
                    pending._result = api.SearchResult(
                        dists=res.dists[sl], ids=res.ids[sl],
                        nprobe_eff=res.nprobe_eff[sl], overflow=res.overflow,
                        stats=api.SearchStats(
                            tier=tier, impl=impl, k=k, sigma=sigma,
                            bucket=res.stats.bucket,
                            cache_hit=res.stats.cache_hit,
                            queue_ms=queue_ms, batch_size=len(queries),
                            shed=False, dedup_hits=res.stats.dedup_hits,
                            latency_ms=latency_ms, stages=stages,
                            epoch=res.stats.epoch))
                    self._c_served().inc(**self._lbl)
                    self._h_queue().observe(queue_ms, **self._lbl)
                    self._h_latency().observe(latency_ms, **self._lbl)
            sp_batch.set(rows=len(queries))
        self._c_batches().inc(**self._lbl)
        self._c_rows().inc(len(queries), **self._lbl)
        self._h_batch_rows().observe(len(queries), group=str(key), **self._lbl)
        if tr.enabled:
            hs = self._h_stage()
            hs.observe(sp_asm.duration_ms, stage="assemble", **self._lbl)
            hs.observe(sp_scat.duration_ms, stage="scatter", **self._lbl)
            for st, ms in (res.stats.stages or {}).items():
                hs.observe(ms, stage=f"serve.{st}", **self._lbl)
        self._t_last_done = t_done

    # ------------------------------------------------------------ telemetry

    def stats(self) -> FrontendStats:
        lbl = self._lbl
        served = int(self._c_served().value(**lbl))
        batches = int(self._c_batches().value(**lbl))
        rows = self._c_rows().value(**lbl)
        lat = self._h_latency()
        span = ((self._t_last_done - self._t_first)
                if self._t_first is not None and self._t_last_done is not None
                else 0.0)
        # a single completion has no observable span (and span can be 0 under
        # a virtual clock): report 0.0 rather than divide noise by epsilon
        qps = rows / span if span > 0 and served >= 2 else 0.0
        return FrontendStats(
            submitted=int(self._c_submitted().value(**lbl)), served=served,
            shed=int(self._c_shed().total(**lbl)), batches=batches,
            depth=self.depth(),
            mean_batch=rows / batches if batches else 0.0,
            p50_ms=lat.quantile(0.50, **lbl),
            p99_ms=lat.quantile(0.99, **lbl),
            qps=qps)


# ------------------------------------------------------------- simulation

def simulate_open_loop(frontend: ServingFrontend, queries: np.ndarray, *,
                       rate_qps: float, n_requests: int,
                       deadline_ms: Optional[float] = None,
                       priority: int = 0, sigma: Optional[float] = None,
                       tier: Optional[str] = None, impl: Optional[str] = None,
                       k: Optional[int] = None):
    """Drive an open-loop single-query arrival stream against the front-end's
    (fake) clock: request ``i`` arrives at ``i / rate_qps`` regardless of
    completions — the offered load does not back off when the system falls
    behind, which is exactly what makes admission control necessary. While the
    next arrival is in the future the clock advances through each pending
    group's deadline and polls, like an event-loop driver would; arrivals the
    clock has already overrun (service time pushed it past them) are submitted
    backdated without intermediate polls — a backlog coalesces through the
    size trigger, and each request's latency, or its dead-on-arrival shed when
    ``deadline_ms`` is set, reflects the backlog it actually experienced.
    Returns ``(stats, pendings)``; the stream is drained before the snapshot,
    so every handle is resolved.

    ``sigma``/``tier``/``impl``/``k`` are stamped onto every request — one
    compatibility group, one serve-cache key (leave them None to inherit the
    engine defaults). Requires ``frontend.clock`` to be advanceable
    (``FakeClock``); with ``charge_service=True`` the simulated timeline also
    carries each engine call's measured wall cost, so p50/p99/QPS reflect
    real serve speed under deterministic arrivals.
    """
    clock = frontend.clock
    if not hasattr(clock, "advance"):
        raise TypeError("simulate_open_loop needs an advanceable clock "
                        "(FakeClock), not wall time")
    pendings = []
    for i in range(n_requests):
        t_arr = i / float(rate_qps)
        # tick deadline flushes only while advancing toward a FUTURE arrival.
        # When service time has pushed the clock past t_arr the backlog is
        # submitted without polling: backdated requests' flush windows are
        # already expired, and polling between them would flush singleton
        # batches — the size trigger is what coalesces a backlog.
        while clock() < t_arr:
            nd = frontend.next_deadline()
            if nd is None or nd > t_arr:
                clock.advance(t_arr - clock())
                break
            if nd > clock():
                clock.advance(nd - clock())
            frontend.poll()
        pendings.append(frontend.submit(api.SearchRequest(
            queries=queries[i % len(queries)], deadline_ms=deadline_ms,
            priority=priority, sigma=sigma, tier=tier, impl=impl, k=k),
            t_arrival=t_arr))
    # end of stream: honor remaining deadlines, then drain
    while True:
        nd = frontend.next_deadline()
        if nd is None:
            break
        if nd > clock():
            clock.advance(nd - clock())
        frontend.poll()
    frontend.drain()
    return frontend.stats(), pendings
