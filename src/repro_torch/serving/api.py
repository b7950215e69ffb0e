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
    config (k/σ/impl from ``cfg.k`` / ``engine.sigma`` / ``cfg.impl``)."""

    queries: Any                    # [nq, dim] array-like
    k: Optional[int] = None
    sigma: Optional[float] = None
    tier: Optional[str] = None
    impl: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SearchStats:
    """Per-call serving telemetry (not part of the ranked answer)."""

    tier: str                       # resolved tier that served the call
    impl: str                       # resolved kernel backend
    k: int
    sigma: float
    bucket: int                     # padded power-of-two batch bucket
    dedup_hits: int = 0             # duplicate candidate slots merged away


@dataclasses.dataclass
class SearchResult:
    """Named serving answer. ``overflow`` counts probes dropped by q_cap
    bucket overflow — persistently nonzero means recall is degraded."""

    dists: np.ndarray               # [nq, k] ascending squared L2, inf-padded
    ids: np.ndarray                 # [nq, k] point ids, -1-padded
    nprobe_eff: np.ndarray          # [nq] effective probes per query
    overflow: int                   # total q_cap-dropped probes this call
    stats: Optional[SearchStats] = None
