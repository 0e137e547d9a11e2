"""qwen1.5-4b — dense transformer with QKV bias.

[hf:Qwen/Qwen1.5-0.5B (family); hf] 40L d_model=2560 20H (GQA kv=20)
d_ff=6912 vocab=151936, QKV bias.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
