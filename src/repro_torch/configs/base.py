"""Config schema of the LIRA system (counterpart of
``repro/configs/base.py:LiraSystemConfig`` and ``FrontendConfig``; the other
architectures' configs are not part of the port)."""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Dynamic-batching front-end knobs (serving/frontend.py). The front-end
    gathers single-query ``SearchRequest``s into coalesced batches, flushed on
    whichever trigger fires first: size (``max_batch`` rows, rounded up to the
    engine's power-of-two batch bucket) or deadline (``max_wait_ms`` since
    enqueue, tightened per request by ``SearchRequest.deadline_ms``). Beyond
    ``max_queue`` waiting requests it sheds load: a shed request resolves at
    once with ``SearchStats.shed=True``. (The reference's retired
    ``latency_window`` knob is not carried: latency quantiles come from
    fixed-bucket histograms.)"""

    max_batch: int = 64             # size trigger, in coalesced query rows
    max_wait_ms: float = 2.0        # deadline trigger for queued requests
    max_queue: int = 256            # admission-control bound, in requests


@dataclasses.dataclass(frozen=True)
class LiraSystemConfig:
    """The paper's own system. Field names and defaults match the JAX config,
    so a JAX checkpoint's ``extra.config`` maps onto it (see
    ``serving.engine.LiraEngine.load_jax``)."""
    arch: str
    dim: int
    n_partitions: int
    capacity: int
    k: int
    nprobe_max: int
    q_hidden: Sequence[int] = (256, 128)
    i_hidden: Sequence[int] = (128,)
    p_hidden: Sequence[int] = (256,)
    dtype: str = "float32"
    store_dtype: str = "float32"    # vector storage (bfloat16 halves scan reads)
    q_cap_factor: float = 2.0       # query-dispatch slack (compute ∝ this)
    auto_q_cap: bool = False        # engine doubles q_cap_factor after
                                    # persistent q_cap overflow
    impl: str = "auto"              # kernel backend: auto | ref | cuda
    tier: str = "f32"               # serving tier: f32 | pq | residual_pq
    pq_m: int = 16                  # PQ subspaces (dim % pq_m == 0)
    pq_ks: int = 256                # codewords per subspace (≤ 256 → uint8 codes)
    rerank: int = 4                 # shortlist depth r: rerank r·k slots per partition
    eta: float = 0.0                # replica fraction (from BuildConfig.eta)
    repartition_threshold: float = 0.25
