"""dimenet [arXiv:2003.03123; unverified] — n_blocks=6 d_hidden=128
n_bilinear=8 n_spherical=7 n_radial=6. Triplet-gather regime. Same values as
``repro/configs/dimenet.py``."""
from repro_torch.configs.base import GNNConfig, GNN_SHAPES
from repro_torch.models.api import ShapeSpec

CONFIG = GNNConfig(
    arch="dimenet",
    n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6,
)
SHAPES = GNN_SHAPES

SMOKE = GNNConfig(
    arch="dimenet-smoke",
    n_blocks=2, d_hidden=32, n_bilinear=4, n_spherical=3, n_radial=4,
)
SMOKE_SHAPES = (
    ShapeSpec("molecule_sm", "graph_train",
              {"n_nodes": 12, "n_edges": 32, "batch": 4, "d_feat": 0, "triplet_mult": 4}),
    ShapeSpec("graph_sm", "graph_train",
              {"n_nodes": 64, "n_edges": 256, "d_feat": 16, "triplet_mult": 4}),
)
