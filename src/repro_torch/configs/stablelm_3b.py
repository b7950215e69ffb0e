"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b family; unverified] — dense: 32L
d_model=2560 32H (GQA kv=32 = MHA, head_dim=80) d_ff=6912 vocab=50304.
Same values as ``repro/configs/stablelm_3b.py``."""
from repro_torch.configs.base import LMConfig, LM_SHAPES
from repro_torch.models.api import ShapeSpec

CONFIG = LMConfig(
    arch="stablelm-3b",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304,
)
SHAPES = LM_SHAPES

SMOKE = LMConfig(
    arch="stablelm-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab=512,
)
SMOKE_SHAPES = (ShapeSpec("train_sm", "train", {"seq_len": 64, "global_batch": 4}),
                ShapeSpec("decode_sm", "decode", {"seq_len": 64, "global_batch": 4}))
