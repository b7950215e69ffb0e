"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf] — 48L d_model=2048
16H (GQA kv=16, head_dim=128) MoE 64 experts top-6 (+2 shared), expert
d_ff=1408, vocab=163840.
Same values as ``repro/configs/moonshot_v1_16b_a3b.py``."""
from repro_torch.configs.base import LMConfig, LM_SHAPES, MoEConfig
from repro_torch.models.api import ShapeSpec

CONFIG = LMConfig(
    arch="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    logits_chunk=8,
)
SHAPES = LM_SHAPES

SMOKE = LMConfig(
    arch="moonshot-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=96, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=1),
)
SMOKE_SHAPES = (ShapeSpec("train_sm", "train", {"seq_len": 64, "global_batch": 4}),
                ShapeSpec("decode_sm", "decode", {"seq_len": 64, "global_batch": 4}))
