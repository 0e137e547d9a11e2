"""UCT scoring and child selection (paper eq. 1).

    UCT(j) = X_j + Cp * sqrt( ln(n) / n_j ),   X_j = w_j / n_j

Virtual loss enters as extra visits with zero wins (lowers X_j and the
exploration bonus), diversifying simultaneous selections — the batched
analogue of the lock contention the paper's threads experience.

This is the plain PyTorch spelling (port of ``repro.core.uct``). On the
card the same arithmetic runs in ``csrc/uct_select.cu``'s ``uct_score``:
the one-tile kernel ``kernels.ops.uct_select`` scores a whole (W, C) level
tile at once (the LM search's descent), the descent kernel
``kernels.ops.select_descent`` scores every level of a selection round in
one launch (the Hex search's). ``cp`` is a run-time value everywhere.
"""

from __future__ import annotations

import torch


def uct_scores(wins: torch.Tensor, visits: torch.Tensor, vloss: torch.Tensor,
               parent_visits: torch.Tensor, cp,
               valid: torch.Tensor) -> torch.Tensor:
    """Vectorized UCT over child slots.

    wins/visits/vloss: (..., C) child stats; parent_visits: (...,) scalar per
    row; valid: (..., C) bool; cp: python float or 0-d tensor.
    Unvisited children get +inf (explored first), invalid slots get -inf.
    """
    n_j = visits + vloss
    n_j1 = torch.clamp(n_j, min=1.0)
    x_j = wins / n_j1
    n_p = torch.clamp(parent_visits, min=1.0)
    explore = cp * torch.sqrt(torch.log(n_p)[..., None] / n_j1)
    score = x_j + explore
    score = torch.where(n_j <= 0.0, torch.inf, score)
    return torch.where(valid, score, -torch.inf)


def noisy_scores(scores: torch.Tensor,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """The scores ``select_child`` takes the argmax of: bounded jitter added
    to finite scores, ``1e30 + noise`` for unvisited children (in float32
    that IS ``1e30``, so ties among them go to the lowest slot — the
    reference's behaviour, kept), ``-inf`` for invalid slots."""
    if noise is None:
        return scores
    # preserve +inf (unvisited-first) and -inf (invalid) semantics
    finite = torch.isfinite(scores)
    scores = torch.where(finite, scores + noise, scores)
    # unvisited children: tie-break among them with noise too
    unv = scores == torch.inf
    return torch.where(unv, 1e30 + noise, scores)


def select_child(scores: torch.Tensor,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """Argmax child slot, with optional per-slot tie-break noise.

    noise is bounded jitter (e.g. eps * uniform) — with noise=None ties break
    toward the lowest slot, matching the sequential reference.
    """
    return torch.argmax(noisy_scores(scores, noise), dim=-1)
