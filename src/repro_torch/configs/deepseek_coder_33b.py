"""deepseek-coder-33b [arXiv:2401.14196; hf] — dense llama-arch: 62L
d_model=7168 56H (GQA kv=8, head_dim=128) d_ff=19200 vocab=32256.
Same values as ``repro/configs/deepseek_coder_33b.py``."""
from repro_torch.configs.base import LMConfig, LM_SHAPES
from repro_torch.models.api import ShapeSpec

CONFIG = LMConfig(
    arch="deepseek-coder-33b",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab=32256,
)
SHAPES = LM_SHAPES

SMOKE = LMConfig(
    arch="deepseek-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab=512,
)
SMOKE_SHAPES = (ShapeSpec("train_sm", "train", {"seq_len": 64, "global_batch": 4}),
                ShapeSpec("decode_sm", "decode", {"seq_len": 64, "global_batch": 4}))
