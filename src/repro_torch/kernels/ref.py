"""Plain PyTorch versions of the hand-written kernels (the ground truth).

Each function mirrors its kernel's public signature. The CPU tests and the
on-card comparison in ``chip_smoke.py`` use them; the search reaches them
only for tensors that lie on the CPU.
"""

from __future__ import annotations

import math

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, H, S, d); k/v: (B, Hkv, S, d) with GQA broadcast (query head
    h reads kv head h // (H / Hkv)). float32 math: q scaled in float32
    before the product, masked scores -inf, softmax, output in q's dtype."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(B, Hkv, G, S, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf * scale, kf)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return o.reshape(B, H, S, d).to(q.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            order: str = "kernel") -> torch.Tensor:
    """x: (..., D); w: (D,). float32 statistics, output in x's dtype.

    ``order`` is where the rounding to x's dtype happens:

    - ``"kernel"``: the TPU kernel's contract (``repro.kernels.ref.rmsnorm``):
      ``x * rsqrt(mean(x^2) + eps) * w`` all in float32, one cast at the end;
    - ``"model"``: the JAX models' ``layers.rmsnorm``: normalise in float32,
      cast to x's dtype, then multiply by ``w`` cast to x's dtype.
    """
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if order == "kernel":
        return (xf * r * w.float()).to(x.dtype)
    if order == "model":
        return (xf * r).to(x.dtype) * w.to(x.dtype)
    raise ValueError(f"rmsnorm: order must be 'kernel' or 'model', got {order!r}")


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


def hex_playout(boards: torch.Tensor, to_move: torch.Tensor,
                keys: torch.Tensor, size: int) -> torch.Tensor:
    """W random playouts of (W, size*size) boards -> (W,) int8 winners:
    ``core.hex.random_fill_batch`` then the plain ``hex_winner``, exactly
    the Hex search's playout stage (the kernel's filled boards are held
    against ``random_fill_batch`` itself)."""
    from repro_torch.core import hex as hx
    filled = hx.random_fill_batch(boards, to_move, keys, hx.HexSpec(size))
    return hex_winner(filled, size)


def select_descent(tree, root_board: torch.Tensor, game, cp,
                   noise_keys: torch.Tensor, noise_scale: float):
    """One selection round: ``core.gscpm.select_levels``, the lockstep level
    loop, run with every kernel dispatch on its plain version. Returns
    ``(paths, depths, leaves, boards, n_empty)``."""
    from repro_torch.core.gscpm import select_levels
    from repro_torch.kernels import ops
    with ops.plain_versions():
        return select_levels(tree, root_board, game, cp, noise_keys,
                             noise_scale)


def propose_move(tree, leaf: torch.Tensor, legal: torch.Tensor,
                 key: torch.Tensor) -> torch.Tensor:
    """A uniformly random legal move that ``leaf`` has no child for yet, -1
    (``NO_NODE``) if there is none: ``core.gscpm.propose_move`` given the
    game's legal mask.

    Batched over leading axes: ``leaf`` (...) member-local ids, ``legal``
    (..., n) bool, ``key`` (..., 2); on a forest the leading axes start
    with the member axis. The argmax of iid uniforms over the untried
    legal cells is a uniform choice; ties go to the first index."""
    from repro_torch import rng
    from repro_torch.core.tree import (NO_NODE, gather_nodes, member_rows,
                                       rows_view)
    n_cells = legal.shape[-1]
    C = tree.max_children
    cap = tree.cap
    dev = legal.device
    rows = member_rows(tree, leaf)
    slots = rows_view(tree, tree.children)[rows]                  # (..., C)
    valid = (torch.arange(C, dtype=torch.int32, device=dev)
             < rows_view(tree, tree.n_children)[rows][..., None])
    tried_moves = torch.where(
        valid, gather_nodes(tree, tree.move, torch.where(valid, slots, cap)),
        n_cells)
    tried = torch.zeros((*legal.shape[:-1], n_cells + 1), dtype=torch.bool,
                        device=dev)
    tried.scatter_(-1, tried_moves.long(), True)
    untried = legal & ~tried[..., :n_cells]
    u = rng.uniform(key, n_cells)
    mv = torch.argmax(torch.where(untried, u, -1.0), dim=-1).to(torch.int32)
    return torch.where(untried.any(dim=-1), mv, NO_NODE)
