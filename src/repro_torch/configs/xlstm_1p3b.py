"""xlstm-1.3b — mLSTM (matrix memory) + sLSTM blocks, 7:1.

[arXiv:2405.04517; unverified] 48L d_model=2048 4H vocab=50304, d_ff=0
(pre-up-projection blocks carry the FFN capacity; proj factor 2).
Every ``slstm_every``-th block is an sLSTM block.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    slstm_every=8,           # 42 mLSTM : 6 sLSTM =~ 7:1
    mlstm_proj_factor=2.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
