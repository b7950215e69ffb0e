"""autoint [arXiv:1810.11921; paper] — n_sparse=39 embed_dim=16
3 self-attn layers, 2 heads, d_attn=32. Same values as
``repro/configs/autoint.py``."""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES
from repro_torch.models.api import ShapeSpec

CONFIG = RecsysConfig(
    arch="autoint", n_dense=0, n_sparse=39, embed_dim=16,
    vocab_per_field=1_000_000, interaction="self-attn",
    n_attn_layers=3, n_heads=2, d_attn=32,
)
SHAPES = RECSYS_SHAPES

SMOKE = RecsysConfig(
    arch="autoint-smoke", n_dense=0, n_sparse=6, embed_dim=8,
    vocab_per_field=128, interaction="self-attn",
    n_attn_layers=2, n_heads=2, d_attn=8,
)
SMOKE_SHAPES = (ShapeSpec("train_sm", "rec_train", {"batch": 64}),
                ShapeSpec("serve_sm", "rec_serve", {"batch": 32}))
