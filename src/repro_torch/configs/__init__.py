"""Architecture registry: ``get_config(id)`` -> ModelConfig (+ reduced twins).

Port of ``repro.configs``' registry: the dense GQA transformers, the MoE
models (Qwen3-MoE; DeepSeek-V2 with MLA), the zamba2 hybrid, xLSTM, the
vlm (PaliGemma) and the encoder-decoder (SeamlessM4T). ``configs.shapes``
holds the dry-run's four input shapes and which cells run.
"""

from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, llama3_8b, paligemma_3b,
                                 qwen3_moe_235b, qwen15_05b, qwen15_4b,
                                 seamless_m4t_medium, smollm_135m,
                                 xlstm_1p3b, zamba2_7b)
from repro_torch.configs.shapes import (SHAPES, ShapeSpec,  # noqa: F401
                                        applicable, tune_for_shape)
from repro_torch.models.common import ModelConfig

_REGISTRY: dict[str, ModelConfig] = {
    "zamba2-7b": zamba2_7b.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
    "smollm-135m": smollm_135m.CONFIG,
    "qwen1.5-0.5b": qwen15_05b.CONFIG,
    "qwen1.5-4b": qwen15_4b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "xlstm-1.3b": xlstm_1p3b.CONFIG,
    "paligemma-3b": paligemma_3b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
}

ARCHS: tuple[str, ...] = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def reduced_config(name: str) -> ModelConfig:
    """Family-faithful small twin: same block structure, CPU-sized dims (the
    JAX package's ``reduced_config``: few layers, narrow width, tiny vocab,
    few experts)."""
    full = get_config(name)
    kw: dict = dict(
        name=full.name + "-reduced",
        d_model=128,
        n_heads=4,
        n_kv_heads=(1 if full.n_kv_heads == 1
                    else (2 if full.n_kv_heads < full.n_heads else 4)),
        head_dim=32 if full.head_dim else 0,
        d_ff=256 if full.d_ff else 0,
        vocab=512,
        param_dtype="float32",
        compute_dtype="float32",
        logits_chunk=0,
        attn_chunk=0,
        remat="none",
    )
    fam = full.family
    if fam == "moe":
        # capacity 8.0: reduced twins are drop-free (the drop set depends on
        # the token count, so prefill and decode would legitimately differ)
        kw.update(n_layers=3 if full.n_dense_layers else 2, n_experts=8,
                  n_experts_per_tok=min(2, full.n_experts_per_tok),
                  moe_d_ff=64, capacity_factor=8.0,
                  n_dense_layers=min(1, full.n_dense_layers))
        if full.use_mla:
            kw.update(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32, d_ff=256)
    elif fam == "hybrid":
        kw.update(n_layers=2 * full.attn_every + 1, attn_every=full.attn_every,
                  ssm_state=16, ssm_headdim=16, ssm_chunk=16, d_ff=256)
    elif fam == "ssm":
        kw.update(n_layers=3, ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    elif fam == "xlstm":
        kw.update(n_layers=2 * full.slstm_every, d_ff=0)
    elif fam == "vlm":
        kw.update(n_layers=2, n_patches=8, vision_width=48)
    elif fam == "encdec":
        kw.update(n_layers=2, n_enc_layers=2, vision_width=48)
    else:
        kw.update(n_layers=2)
    return full.replace(**kw)
