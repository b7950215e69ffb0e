"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf] — 94L d_model=4096
64H (GQA kv=4, head_dim=128) MoE 128 experts top-8, expert d_ff=1536,
vocab=151936.
Same values as ``repro/configs/qwen3_moe_235b_a22b.py``,
its training knobs left out (see ``base.LMConfig``)."""
from repro_torch.configs.base import LMConfig, LM_SHAPES, MoEConfig
from repro_torch.models.api import ShapeSpec

CONFIG = LMConfig(
    arch="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
)
SHAPES = LM_SHAPES

SMOKE = LMConfig(
    arch="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=96, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96),
)
SMOKE_SHAPES = (ShapeSpec("train_sm", "train", {"seq_len": 64, "global_batch": 4}),
                ShapeSpec("decode_sm", "decode", {"seq_len": 64, "global_batch": 4}))
