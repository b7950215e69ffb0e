"""lira-ann — the paper's own system (WWW'25): B=1024 partitions over a 67M-
point store (large-scale setting, paper §4.1). Same values as
``repro/configs/lira_ann.py``."""
from repro_torch.configs.base import LiraSystemConfig

CONFIG = LiraSystemConfig(
    arch="lira-ann", dim=128, n_partitions=1024, capacity=65536, k=100,
    nprobe_max=64,
)

SMOKE = LiraSystemConfig(
    arch="lira-smoke", dim=16, n_partitions=16, capacity=64, k=10,
    nprobe_max=4,
)
