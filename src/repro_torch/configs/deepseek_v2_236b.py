"""deepseek-v2-236b — MLA + fine-grained MoE (2 shared + 160 routed, top-6).

[arXiv:2405.04434; hf] 60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536,
qk_nope=128 / qk_rope=64 / v=128), expert d_ff=1536, vocab=102400,
first layer dense (d_ff=12288), 2 shared + 160 routed experts top-6.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: per-head KV is derived from the latent
    d_ff=12288,              # the single leading dense layer's FFN
    vocab=102_400,
    n_experts=160,
    n_experts_per_tok=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    n_dense_layers=1,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
