"""Typed serving surface: SearchRequest → LiraEngine.search → SearchResult
(counterpart of ``repro/serving/api.py``, without the deprecation shims that
serve only legacy JAX callers)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Everything ``LiraEngine.build`` needs beyond the data itself."""

    n_partitions: int
    k: int = 100
    eta: float = 0.03               # replica redundancy rate (paper §3.3)
    train_frac: float = 0.5         # fraction of base vectors used to train probing
    epochs: int = 8
    nprobe_max: Optional[int] = None  # None → max(8, n_partitions // 8)
    seed: int = 0
    log: bool = False
    tier: str = "f32"               # serving tier: f32 | pq | residual_pq
    pq_m: Optional[int] = None      # PQ subspaces; None → largest divisor of dim ≤ 16
    pq_ks: int = 256                # codewords per subspace (≤ 256 → uint8 codes)
    rerank: int = 4                 # shortlist depth r: rerank r·k slots per partition
    impl: str = "auto"              # kernel backend: auto | ref | cuda
    store_dtype: str = "float32"    # vector plane dtype (bfloat16 halves scan reads)
    q_cap_factor: float = 2.0
    auto_q_cap: bool = False        # grow q_cap_factor on persistent overflow
    sigma: float = 0.5              # engine's default probe threshold


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """One query batch + per-call overrides; ``None`` inherits the engine's
    config (k/σ/impl from ``cfg.k`` / ``engine.sigma`` / ``cfg.impl``). The
    batching hints (``deadline_ms``, ``priority``, ``allow_batching``) matter
    only through the serving front-end (serving/frontend.py); requests
    coalesce into one batch only when their resolved (k, σ, tier, impl)
    agree."""

    queries: Any                    # [nq, dim] array-like
    k: Optional[int] = None
    sigma: Optional[float] = None
    tier: Optional[str] = None
    impl: Optional[str] = None
    # per-request SLO: tightens the flush window to min(max_wait_ms, this)
    # and arms dead-on-arrival shedding; None = batching window only
    deadline_ms: Optional[float] = None
    priority: int = 0               # higher wins under admission pressure
    allow_batching: bool = True     # False → served solo, bypassing the queue


@dataclasses.dataclass(frozen=True)
class SearchStats:
    """Per-call serving telemetry (not part of the ranked answer). The
    queue/batch fields are the front-end's; a direct ``engine.search`` leaves
    them at their defaults (``batch_size=0``: not front-end batched).
    ``latency_ms`` and ``stages`` (milliseconds, summing to about
    ``latency_ms``) are filled only when a Tracer is attached."""

    tier: str                       # resolved tier that served the call
    impl: str                       # resolved kernel backend
    k: int
    sigma: float
    bucket: int                     # padded power-of-two batch bucket
    cache_hit: bool = False         # the serve cache held this call's step
    queue_ms: float = 0.0           # time queued before the batch launched
    batch_size: int = 0             # coalesced rows in the batch that served this
    shed: bool = False              # dropped by admission control, no answer
    dedup_hits: int = 0             # duplicate candidate slots merged away
    latency_ms: float = 0.0         # end-to-end latency (0.0 when not traced)
    stages: Optional[dict] = None   # {"prepare": ms, "device": ms, ...}
    epoch: int = 0                  # store epoch that served the call
    # cluster serving (serving/cluster.py): a merged cluster answer leaves
    # shard and replica None and carries one (shard, replica, hedged,
    # failovers) tuple a shard in ``routes``; ``failovers`` counts in-flight
    # batches replayed off dead replicas while serving this call (nonzero:
    # the answer survived a failure, nothing was lost)
    shard: Optional[int] = None     # shard that served (None: an engine, or merged)
    replica: Optional[int] = None   # replica that won within the shard group
    hedged: bool = False            # a hedge request was issued for this call
    failovers: int = 0              # in-flight replays absorbed by this call
    routes: Optional[tuple] = None  # merged answers: per-shard route tuples


@dataclasses.dataclass
class SearchResult:
    """Named serving answer. ``overflow`` counts probes dropped by q_cap
    bucket overflow — persistently nonzero means recall is degraded."""

    dists: np.ndarray               # [nq, k] ascending squared L2, inf-padded
    ids: np.ndarray                 # [nq, k] point ids, -1-padded
    nprobe_eff: np.ndarray          # [nq] effective probes per query
    overflow: int                   # total q_cap-dropped probes this call
    stats: Optional[SearchStats] = None
