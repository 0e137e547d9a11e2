"""Plain PyTorch versions of the hand-written kernels (the ground truth).

Each function mirrors its kernel's public signature. The CPU tests and the
on-card comparison in ``chip_smoke.py`` use them; the search reaches them
only for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch


def uct_select(wins: torch.Tensor, visits: torch.Tensor, vloss: torch.Tensor,
               parent_total: torch.Tensor, valid: torch.Tensor,
               cp, noise: torch.Tensor | None = None,
               lane_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(W, C) child stats -> (W,) int32 best child slot (paper eq. 1 +
    tie-break).

    ``lane_mask`` (W,) bool marks live lanes (a masked row is all-invalid
    and deterministically yields slot 0).
    """
    from repro_torch.core.uct import select_child, uct_scores
    if lane_mask is not None:
        valid = valid & lane_mask[..., None]
    scores = uct_scores(wins, visits, vloss, parent_total, cp, valid)
    return select_child(scores, noise).to(torch.int32)


def hex_winner(boards: torch.Tensor, size: int) -> torch.Tensor:
    """(W, size*size) FILLED boards -> (W,) int8 winners in {1, 2}.

    Same filled-board contract as the kernel (``repro_torch.core.hex.winner``).
    The batched pointer-doubling solve in ``repro_torch.core.hex`` IS the
    plain semantics: one connectivity check for BLACK decides every lane
    (the Hex theorem).
    """
    from repro_torch.core import hex as hx
    black = hx.connected_batch(boards, hx.BLACK, hx.HexSpec(size))
    return torch.where(black, 1, 2).to(torch.int8)
