"""Roofline terms of a dry-run cell (port of ``repro.roofline.terms``), with
the H100's constants (``roofline.hw``):

    compute    = flops_per_chip / BF16_TENSOR_OPS_PER_S
    memory     = hbm_bytes_per_chip / HBM_BYTES_PER_S
    collective = wire_bytes_per_chip / NVLINK_BYTES_PER_S   (0 on one card)

MODEL_FLOPS is the analytic useful work:
    train:   6 * N_active * tokens   (fwd 2ND + bwd 4ND)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch    (one token per slot)
(+ the attention S^2 term, reported separately since 6ND ignores it).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.common import ModelConfig
from repro_torch.roofline import hw


def active_params(cfg: ModelConfig, n_params: int) -> int:
    """Parameters touched per token (MoE: shared + top-k routed only)."""
    if cfg.family != "moe":
        return n_params
    ff = cfg.moe_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * ff
    routed_total = cfg.n_experts * per_expert
    moe_layers = cfg.n_layers - cfg.n_dense_layers
    active_routed = cfg.n_experts_per_tok * per_expert
    return n_params - moe_layers * (routed_total - active_routed)


def model_flops(cfg: ModelConfig, n_params: int, kind: str, seq_len: int,
                global_batch: int) -> float:
    n_act = active_params(cfg, n_params)
    tokens = seq_len * global_batch
    if kind == "train":
        return 6.0 * n_act * tokens
    if kind == "prefill":
        return 2.0 * n_act * tokens
    return 2.0 * n_act * global_batch        # decode: one new token per slot


def attn_flops(cfg: ModelConfig, kind: str, seq_len: int,
               global_batch: int) -> float:
    """Quadratic-attention FLOPs (causal, counted as the full masked
    matmul; 2 matmuls QK^T + PV)."""
    if cfg.family in ("ssm", "xlstm"):
        return 0.0
    H = cfg.n_heads
    hd = cfg.hd
    if cfg.use_mla:
        hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
    elif cfg.family == "encdec":
        n_attn = cfg.n_enc_layers + 2 * cfg.n_layers   # self + cross
    else:
        n_attn = cfg.n_layers
    if kind == "decode":
        per = 2 * 2 * H * hd * seq_len                 # one query vs S keys
        f = global_batch * n_attn * per
    else:
        per = 2 * 2 * H * hd * seq_len * seq_len
        f = global_batch * n_attn * per
    return (3.0 if kind == "train" else 1.0) * f


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    chips: int
    model_flops_global: float
    attn_flops_global: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / hw.BF16_TENSOR_OPS_PER_S

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / hw.HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_chip / hw.NVLINK_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much counted compute is
        useful."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips * peak * roofline step time)."""
        denom = self.chips * hw.BF16_TENSOR_OPS_PER_S * self.step_time_s
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "chips": self.chips,
            "model_flops_global": self.model_flops_global,
            "attn_flops_global": self.attn_flops_global,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_ratio": self.useful_ratio,
            "mfu": self.mfu,
        }
