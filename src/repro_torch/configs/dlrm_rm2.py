"""dlrm-rm2 [arXiv:1906.00091; paper] — n_dense=13 n_sparse=26 embed_dim=64
bot_mlp=13-512-256-64 top_mlp=512-512-256-1, dot interaction, multi-hot bags.
Same values as ``repro/configs/dlrm_rm2.py``."""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES
from repro_torch.models.api import ShapeSpec

CONFIG = RecsysConfig(
    arch="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
    vocab_per_field=1_000_000, interaction="dot",
    bot_mlp=(13, 512, 256, 64), top_mlp=(512, 512, 256, 1), nnz=4,
)
SHAPES = RECSYS_SHAPES

SMOKE = RecsysConfig(
    arch="dlrm-smoke", n_dense=4, n_sparse=6, embed_dim=8,
    vocab_per_field=128, interaction="dot",
    bot_mlp=(4, 16, 8), top_mlp=(32, 16, 1), nnz=2,
)
SMOKE_SHAPES = (ShapeSpec("train_sm", "rec_train", {"batch": 64}),
                ShapeSpec("serve_sm", "rec_serve", {"batch": 32}))
