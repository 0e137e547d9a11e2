"""PaliGemma-style VLM support, the stub frontend's bookkeeping (port of
``repro.models.vlm``).

The SigLIP frontend is a stub: the caller supplies precomputed patch
embeddings (B, n_patches, vision_width) (n_patches = 256 at 224px and
patch 14, vision_width = 1152 for paligemma-3b). The backbone work — the
``vision_proj`` projection to d_model, the prefix-LM mask over
[patches | prompt], the gemma decoder — lives in
``repro_torch.models.transformer`` (family ``"vlm"``).
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig


def patch_spec(cfg: ModelConfig, batch: int) -> tuple[tuple[int, ...], torch.dtype]:
    """(shape, dtype) of the stub patch-embedding input."""
    return (batch, cfg.n_patches, cfg.vision_width), cfg.cdtype


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens occupy the sequence budget left after the patch prefix."""
    if seq_len <= cfg.n_patches:
        raise ValueError(f"text_len: seq_len {seq_len} leaves no text after "
                         f"{cfg.n_patches} patches")
    return seq_len - cfg.n_patches


def fake_patches(cfg: ModelConfig, batch: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Seeded stand-in frontend output, 0.02 x a standard normal, on the
    generator's device (not the JAX package's bits)."""
    shape, dtype = patch_spec(cfg, batch)
    z = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (0.02 * z).to(dtype)
