"""Config schema (counterpart of ``repro/configs/base.py``): the LM
architectures' ``MoEConfig`` / ``LMConfig`` and their shapes, and the LIRA
system's ``LiraSystemConfig`` and ``FrontendConfig``. The GNN and recsys
configs are not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.models.api import ShapeSpec


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared: int = 0               # shared (always-on) experts


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX config's serving fields, with its names and defaults. Its
    training knobs (``remat``, ``logits_chunk``, ``grad_accum``) and mesh
    knobs (``moe_impl``, ``ffn_impl``) come with the slices that read them."""
    arch: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"
    attn_block: int = 1024          # flash-scan KV block
    attn_score_dtype: str = "float32"  # float32 | bfloat16 (materialized scores)

    @property
    def param_count(self) -> int:
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv_heads * self.head_dim * 2
        if self.moe is not None:
            ff = 3 * d * self.moe.d_ff_expert * (self.moe.n_experts + self.moe.n_shared) + d * self.moe.n_experts
        else:
            ff = 3 * d * f
        return l * (attn + ff + 2 * d) + 2 * v * d + d

    @property
    def active_param_count(self) -> int:
        """Per-token active params (MoE counts top_k + shared experts only)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv_heads * self.head_dim * 2
        if self.moe is not None:
            ff = 3 * d * self.moe.d_ff_expert * (self.moe.top_k + self.moe.n_shared) + d * self.moe.n_experts
        else:
            ff = 3 * d * f
        return l * (attn + ff + 2 * d) + 2 * v * d + d


LM_SHAPES: Sequence[ShapeSpec] = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)


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


LIRA_SHAPES: Sequence[ShapeSpec] = (
    ShapeSpec("serve_10k", "lira_serve", {"n_queries": 8192}),
    ShapeSpec("train_probe", "lira_train", {"batch": 4096}),
)
