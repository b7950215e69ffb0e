"""lira-ann-q — the quantized two-stage serving tier of lira-ann: residual-PQ
ADC shortlist over uint8 codes (+ the residual offsets, core/pq.py) + exact
f32 rerank (serving/quantized.py). Same values as
``repro/configs/lira_ann_q.py``."""
from repro_torch.configs.lira_ann import (  # noqa: F401
    CONFIG_QUANTIZED as CONFIG,
    SHAPES,
    SMOKE_QUANTIZED as SMOKE,
    SMOKE_SHAPES,
)
