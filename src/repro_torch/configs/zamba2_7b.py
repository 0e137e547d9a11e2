"""zamba2-7b — Mamba2 backbone + alternating shared attention blocks.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64. Every ``attn_every`` Mamba-2 blocks, one of the
``n_shared_blocks`` *shared* (weight-reused) attention+MLP blocks is applied,
alternating between the two shared blocks (DESIGN.md §5).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32_000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    attn_every=6,
    n_shared_blocks=2,
    tie_embeddings=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
