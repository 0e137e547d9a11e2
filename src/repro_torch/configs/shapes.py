"""Assigned input shapes and per-(arch × shape) applicability (port of
``repro.configs.shapes``).

Four LM shapes per architecture (40 cells total):

    train_4k      seq_len=4,096   global_batch=256   -> train_step
    prefill_32k   seq_len=32,768  global_batch=32    -> prefill_step
    decode_32k    seq_len=32,768  global_batch=128   -> serve_step
    long_500k     seq_len=524,288 global_batch=1     -> serve_step

``decode_*`` / ``long_*`` are one-new-token serve steps against a KV cache
of ``seq_len``. ``long_500k`` needs sub-quadratic attention and is skipped
for pure full-attention architectures; it runs for the SSM/hybrid archs
(zamba2, xlstm) whose decode state is O(1)/O(L).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# families whose decode-time attention state is sub-quadratic in seq_len
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid", "xlstm")


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for one (arch × shape) cell."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "skip(full-attn): 500k KV decode needs sub-quadratic attention"
    return True, ""


def tune_for_shape(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Shape-driven memory knobs, the reference's: remat, chunked
    cross-entropy and q-chunked attention, set so that a cell's live
    activations stay bounded (fit-the-machine settings, not tuning)."""
    kw: dict = {}
    if shape.kind == "train":
        # chunked CE keeps live logits at chunk x vocab
        kw["logits_chunk"] = 512
        # full remat + q-chunked attention: unremat'd (B, H, S, S) float32
        # scores are gigabytes a layer at 4k even for the small archs
        kw["remat"] = "full"
        if shape.seq_len >= 2048:
            kw["attn_chunk"] = 512
    if shape.kind == "prefill" and shape.seq_len >= 8_192:
        kw["attn_chunk"] = 1024  # live scores bounded to (B, H, chunk, S)
        kw["remat"] = "full" if cfg.d_model >= 2048 else cfg.remat
    return cfg.replace(**kw) if kw else cfg
