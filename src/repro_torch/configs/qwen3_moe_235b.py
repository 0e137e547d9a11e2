"""qwen3-moe-235b-a22b — 128-expert top-8 MoE, GQA kv=4, head_dim 128.

[hf:Qwen/Qwen3-30B-A3B (family); hf] 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936, MoE 128e top-8 with normalized top-k probs,
explicit head_dim=128 (64 x 128 != d_model).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151_936,
    n_experts=128,
    n_experts_per_tok=8,
    moe_d_ff=1536,
    norm_topk_prob=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
