"""lira-ann — the paper's own system (WWW'25): B=1024 partitions over a 67M-
point store (large-scale setting, paper §4.1). Same values as
``repro/configs/lira_ann.py``."""
from repro_torch.configs.base import LIRA_SHAPES, LiraSystemConfig
from repro_torch.models.api import ShapeSpec

CONFIG = LiraSystemConfig(
    arch="lira-ann", dim=128, n_partitions=1024, capacity=65536, k=100,
    nprobe_max=64,
)
SHAPES = LIRA_SHAPES

# residual_pq tier: uint8 PQ codes (m=16, ks=256 → 16 B a slot against 512 B
# of f32), exact f32 rerank of the r·k shortlist; the codes encode
# x − centroid, at the cost of a per-slot f32 cterm plane and a
# per-(query, partition) offset in the scan.
CONFIG_QUANTIZED = LiraSystemConfig(
    arch="lira-ann-q", dim=128, n_partitions=1024, capacity=65536, k=100,
    nprobe_max=64, tier="residual_pq", pq_m=16, pq_ks=256, rerank=4,
)

SMOKE = LiraSystemConfig(
    arch="lira-smoke", dim=16, n_partitions=16, capacity=64, k=10,
    nprobe_max=4,
)

SMOKE_QUANTIZED = LiraSystemConfig(
    arch="lira-smoke-q", dim=16, n_partitions=16, capacity=64, k=10,
    nprobe_max=4, tier="residual_pq", pq_m=2, pq_ks=16, rerank=4,
)
SMOKE_SHAPES = (ShapeSpec("serve_sm", "lira_serve", {"n_queries": 64}),
                ShapeSpec("train_sm", "lira_train", {"batch": 64}))
