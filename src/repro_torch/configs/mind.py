"""mind [arXiv:1904.08030; unverified] — embed_dim=64 n_interests=4
capsule_iters=3, multi-interest retrieval. Same values as
``repro/configs/mind.py``."""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES
from repro_torch.models.api import ShapeSpec

CONFIG = RecsysConfig(
    arch="mind", n_dense=0, n_sparse=1, embed_dim=64,
    vocab_per_field=1_000_000, interaction="multi-interest",
    n_interests=4, capsule_iters=3, hist_len=50,
)
SHAPES = RECSYS_SHAPES

SMOKE = RecsysConfig(
    arch="mind-smoke", n_dense=0, n_sparse=1, embed_dim=16,
    vocab_per_field=128, interaction="multi-interest",
    n_interests=2, capsule_iters=2, hist_len=10,
)
SMOKE_SHAPES = (ShapeSpec("train_sm", "rec_train", {"batch": 64}),
                ShapeSpec("serve_sm", "rec_serve", {"batch": 32}))
