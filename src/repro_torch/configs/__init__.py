"""Architecture registry: ``get_config(id)`` -> ModelConfig (+ reduced twins).

Port of ``repro.configs`` for the dense GQA transformers, the family this
slice of the port runs. The other architectures of the JAX package's
registry are known by name and refused with ``NotImplementedError`` (their
families are ROADMAP.md item A12).
"""

from __future__ import annotations

from repro_torch.configs import llama3_8b, qwen15_05b, qwen15_4b, smollm_135m
from repro_torch.models.common import ModelConfig

_REGISTRY: dict[str, ModelConfig] = {
    "llama3-8b": llama3_8b.CONFIG,
    "smollm-135m": smollm_135m.CONFIG,
    "qwen1.5-0.5b": qwen15_05b.CONFIG,
    "qwen1.5-4b": qwen15_4b.CONFIG,
}
# in the JAX package's registry, not ported yet
_NOT_PORTED = ("zamba2-7b", "deepseek-v2-236b", "qwen3-moe-235b-a22b",
               "xlstm-1.3b", "paligemma-3b", "seamless-m4t-medium")

ARCHS: tuple[str, ...] = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r}: its family is not ported yet (ROADMAP.md item "
            "A12); the port runs the dense GQA transformers "
            f"{sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def reduced_config(name: str) -> ModelConfig:
    """Family-faithful small twin: same block structure, CPU-sized dims
    (the JAX package's ``reduced_config`` for the dense family)."""
    full = get_config(name)
    return full.replace(
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
        n_layers=2,
    )
