"""qwen1.5-0.5b — dense transformer with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf] 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias, tied embeddings.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
