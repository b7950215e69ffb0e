"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified] —
dense: 88L d_model=12288 96H (GQA kv=8, head_dim=128) d_ff=28672 vocab=32768.
Same values as ``repro/configs/mistral_large_123b.py``."""
from repro_torch.configs.base import LMConfig, LM_SHAPES
from repro_torch.models.api import ShapeSpec

CONFIG = LMConfig(
    arch="mistral-large-123b",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768,
    grad_accum=4,
)
SHAPES = LM_SHAPES

SMOKE = LMConfig(
    arch="mistral-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab=512,
)
SMOKE_SHAPES = (ShapeSpec("train_sm", "train", {"seq_len": 64, "global_batch": 4}),
                ShapeSpec("decode_sm", "decode", {"seq_len": 64, "global_batch": 4}))
