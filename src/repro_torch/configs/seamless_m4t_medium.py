"""seamless-m4t-medium — encoder-decoder, multimodal (speech frontend stub).

[arXiv:2308.11596; hf] 12L enc + 12L dec, d_model=1024 16H d_ff=4096
vocab=256206. The speech frontend is a stub: the caller supplies
precomputed frame embeddings (width 1024, w2v-BERT-style) consumed by the
bidirectional encoder; the causal decoder cross-attends to the encoded
memory.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,             # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256_206,
    vision_width=1024,       # stub frame-embedding width (frontend output)
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
