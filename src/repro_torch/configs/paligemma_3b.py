"""paligemma-3b — SigLIP(stub) + gemma-2b decoder, prefix-LM masking.

[arXiv:2407.07726; hf] 18L d_model=2048 8H (MQA kv=1, head_dim=256)
d_ff=16384 vocab=257216. The SigLIP frontend is a stub: the caller
supplies 256 precomputed patch embeddings of width 1152 (so400m/14 @
224px; ``models.vlm.fake_patches`` makes seeded ones); the model projects
them to d_model and applies a bidirectional prefix mask over
[patches | prompt].
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257_216,
    act="gelu",
    tie_embeddings=True,
    n_patches=256,
    vision_width=1152,
    prefix_lm=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
