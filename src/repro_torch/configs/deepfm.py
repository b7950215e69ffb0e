"""deepfm [arXiv:1703.04247; paper] — n_sparse=39 embed_dim=10
mlp=400-400-400, FM interaction. Same values as ``repro/configs/deepfm.py``."""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES
from repro_torch.models.api import ShapeSpec

CONFIG = RecsysConfig(
    arch="deepfm", n_dense=0, n_sparse=39, embed_dim=10,
    vocab_per_field=1_000_000, interaction="fm", mlp=(400, 400, 400),
)
SHAPES = RECSYS_SHAPES

SMOKE = RecsysConfig(
    arch="deepfm-smoke", n_dense=0, n_sparse=6, embed_dim=8,
    vocab_per_field=128, interaction="fm", mlp=(32, 32),
)
SMOKE_SHAPES = (ShapeSpec("train_sm", "rec_train", {"batch": 64}),
                ShapeSpec("serve_sm", "rec_serve", {"batch": 32}))
