"""Kernel microbenches on the port: each kernel against its plain version,
at the JAX twin's shapes.

The torch twin of ``benchmarks/kernels_micro.py``. Off the TPU the JAX twin
validates its Pallas kernels in interpret mode and times the jnp oracle;
here the timed path is the one users hit on the card: the hand-written CUDA
kernel behind ``kernels.ops``. Every entry records

- ``max_abs_err``: the kernel's largest error against its plain PyTorch
  version (``kernels.ref``) on the same inputs, and the tolerance it is
  held to (asserted);
- ``ms``, ``plain_ms`` and, where one PyTorch call computes the same
  function, ``library_ms`` (``F.scaled_dot_product_attention``,
  ``F.rms_norm``): batches of calls timed by CUDA events, the three taken
  in turns (``common.ms_in_turns``);
- ``bound_ms`` / ``bound_by``: the bytes each input read once and each
  output written once over 3.35 TB/s, or the operations over 67 T/s
  (float32, integer) or 989 T/s (bf16 on the tensor cores), the larger;
- ``dispatch``: ``"cuda_kernel"`` on the card, ``"plain"`` on the CPU
  (where ``kernels.ops`` runs the plain version and there is nothing to
  compare); ``body``, for flash attention and rmsnorm on the card, names
  the kernel body that ran.

The playout pipeline is the fused ``hex_playout`` (fill and winner in one
launch), timed on empty boards for ``playout_eval_per_s`` (boards/s), with
``hex_winner`` on the same boards filled beside it. The Gomoku playout has
no kernel in either package: its PyTorch body is timed and labelled so.
Inputs come from ``seed`` (numpy for the float inputs; the port's threefry,
which equals ``jax.random``'s, for the playout keys, so the Hex and Gomoku
boards are the JAX twin's own).

    PYTHONPATH=src python -m benchmarks_torch.kernels_micro [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.core import game as game_mod
from repro_torch.core import hex as hx
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

from benchmarks_torch.common import (BF16_TENSOR_OPS_PER_S, OPS_PER_S,
                                     bound_ms, device_stamp, ms_in_turns,
                                     resolve_device, save_result)

# the JAX twin's shapes
FLASH_SHAPES = ((1, 4, 2, 256, 64), (1, 8, 8, 512, 64))   # B, H, Hkv, S, d
FLASH_DTYPES = ("float32", "bfloat16")
UCT_SHAPES = ((128, 128), (1024, 128))                    # W, C
HEX_SHAPES = ((9, 16), (11, 16), (11, 128))               # size, W
GOMOKU_SHAPES = ((9, 16), (11, 64))                       # size, W
RMSNORM_SHAPES = ((4096, 1024), (256, 8192))              # N, D

# the kernel against its plain version on the same inputs
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2.5e-2}
RMSNORM_TOL = 1e-5
# per threefry call and per uniform (chip_smoke.py's count)
THREEFRY_OPS = 119
UNIFORM_OPS = THREEFRY_OPS + 4


def rmsnorm_body(dtype: torch.dtype, D: int) -> str:
    """Which body of ``csrc/rmsnorm.cu`` a contiguous row of D takes: rows
    held in registers as 16-byte vectors up to 4096 bf16 / 2048 float32
    elements, longer rows two passes."""
    limit = 4096 if dtype == torch.bfloat16 else 2048
    vec = 8 if dtype == torch.bfloat16 else 4
    if D % vec:
        limit = 1024
    return "one_pass" if D <= limit else "two_pass"


def flash_inputs(shape, dtype: str, seed: int, device) -> tuple:
    B, H, Hkv, S, d = shape
    g = np.random.default_rng([seed, S, H])
    dt = getattr(torch, dtype)
    return tuple(torch.tensor(g.standard_normal((B, h, S, d)),
                              dtype=torch.float32).to(device=device, dtype=dt)
                 for h in (H, Hkv, Hkv))


def uct_inputs(W: int, C: int, seed: int, device) -> tuple:
    """wins, visits, vloss, parent totals, valid; cp = 1 (the JAX twin's
    draws, from numpy)."""
    g = np.random.default_rng([seed, W, C])
    visits = np.round(g.uniform(size=(W, C)) * 50).astype(np.float32)
    wins = np.round(g.uniform(size=(W, C)) * visits).astype(np.float32)
    valid = g.uniform(size=(W, C)) > 0.2
    ptot = np.maximum(visits.sum(-1), 1.0).astype(np.float32)
    t = lambda a: torch.tensor(a, device=device)
    return (t(wins), t(visits), torch.zeros((W, C), device=device), t(ptot),
            t(valid))


def playout_keys(size: int, W: int, offset: int, seed: int, device):
    """The JAX twin's keys: split(fold_in(key(seed), offset + size * W), W)."""
    return rng.split(rng.fold_in(rng.key(seed, device), offset + size * W), W)


def hex_inputs(size: int, W: int, seed: int, device) -> tuple:
    """(empty boards, movers, keys, the boards filled by those keys)."""
    spec = hx.HexSpec(size)
    keys = playout_keys(size, W, 7000, seed, device)
    empty = hx.empty_board(spec, device).expand(W, -1).contiguous()
    movers = torch.ones(W, dtype=torch.int32, device=device)
    filled = hx.random_fill_batch(empty, 1, keys, spec)
    return empty, movers, keys, filled


def rmsnorm_inputs(N: int, D: int, seed: int, device) -> tuple:
    g = np.random.default_rng([seed, D])
    x = torch.tensor(g.standard_normal((N, D)), dtype=torch.float32,
                     device=device)
    return x, torch.ones(D, dtype=torch.float32, device=device)


def _entry(device, times: dict, err, tol, bound) -> dict:
    out = {"dispatch": "cuda_kernel" if device.type == "cuda" else "plain",
           "max_abs_err": err, "tolerance": tol,
           "ms": times["kernel"], "plain_ms": times["plain"],
           "library_ms": times.get("library"),
           "bound_ms": bound[0], "bound_by": bound[1]}
    assert err <= tol, f"kernel differs from its plain version by {err}"
    return out


def run_flash(device, seed: int, shapes=FLASH_SHAPES,
              dtypes=FLASH_DTYPES, iters: int = 50) -> dict:
    out = {}
    for shape in shapes:
        B, H, Hkv, S, d = shape
        for dtype in dtypes:
            q, k, v = flash_inputs(shape, dtype, seed, device)
            before = dict(fa.flash_attention.launches_by_body)
            got = ops.flash_attention(q, k, v, causal=True, layout="bhsd")
            ran = [b for b in fa.BODIES
                   if fa.flash_attention.launches_by_body[b] > before[b]]
            want = ref.flash_attention(q, k, v, causal=True)
            err = float((got.float() - want.float()).abs().max())
            times = ms_in_turns({
                "kernel": lambda: ops.flash_attention(q, k, v, causal=True,
                                                      layout="bhsd"),
                "plain": lambda: ref.flash_attention(q, k, v, causal=True),
                "library": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=H != Hkv)},
                device, iters=iters)
            elem = q.element_size()
            body = fa.body_for(q.dtype, d)
            assert ran == ([body] if device.type == "cuda" else []), \
                f"flash_attention {shape} {dtype}: ran {ran}, not {body}"
            n_bytes = elem * (2 * B * H * S * d + 2 * B * Hkv * S * d)
            n_ops = 4 * B * H * (S * (S + 1) // 2) * d      # causal pairs
            rate = (BF16_TENSOR_OPS_PER_S if body == "tensor_cores"
                    else OPS_PER_S)
            e = _entry(device, times, err, FLASH_TOL[dtype],
                       bound_ms(n_bytes, n_ops, rate))
            e.update(body=body if device.type == "cuda" else None,
                     dtype=dtype,
                     gflops=n_ops / (times["kernel"] * 1e-3) / 1e9)
            out[f"B{B}H{H}Hkv{Hkv}S{S}d{d}_{dtype}"] = e
    return out


def run_uct(device, seed: int, shapes=UCT_SHAPES, iters: int = 50) -> dict:
    out = {}
    for W, C in shapes:
        args = uct_inputs(W, C, seed, device)
        got = ops.uct_select(*args, 1.0)
        want = ref.uct_select(*args, 1.0)
        err = float((got.long() - want.long()).abs().max())
        times = ms_in_turns({
            "kernel": lambda: ops.uct_select(*args, 1.0),
            "plain": lambda: ref.uct_select(*args, 1.0)}, device,
            iters=iters)
        # wins, visits, vloss (f32), valid (bool), totals read; slots written
        n_bytes = 12 * W * C + W * C + 4 * W + 4 * W
        e = _entry(device, times, err, 0, bound_ms(n_bytes, 12 * W * C))
        e["selections_per_s"] = W / (times["kernel"] * 1e-3)
        out[f"W{W}C{C}"] = e
    return out


def run_hex(device, seed: int, shapes=HEX_SHAPES, iters: int = 50) -> dict:
    out = {}
    for size, W in shapes:
        n = size * size
        empty, movers, keys, filled = hex_inputs(size, W, seed, device)
        win = ops.hex_winner(filled, size)
        win_err = float((win.long() - ref.hex_winner(filled, size).long())
                        .abs().max())
        po = ops.hex_playout(empty, movers, keys, size)
        po_err = float((po.long() - ref.hex_playout(empty, movers, keys, size)
                        .long()).abs().max())
        winner_t = ms_in_turns({
            "kernel": lambda: ops.hex_winner(filled, size),
            "plain": lambda: ref.hex_winner(filled, size)}, device,
            iters=iters)
        playout_t = ms_in_turns({
            "kernel": lambda: ops.hex_playout(empty, movers, keys, size),
            "plain": lambda: ref.hex_playout(empty, movers, keys, size)},
            device, iters=iters)
        rounds = hx.doubling_rounds(n)
        # per round and cell: 6 neighbour tests and mins, 2 atomic mins, a
        # jump; a playout adds a uniform a cell and E x E rank comparisons
        winner = _entry(device, winner_t, win_err, 0,
                        bound_ms(W * n + W, W * n * rounds * 20))
        playout = _entry(device, playout_t, po_err, 0, bound_ms(
            W * n + 4 * W + 16 * W + W,
            W * n * UNIFORM_OPS + 3 * W * n * n + W * n * rounds * 20))
        out[f"{size}x{size}W{W}"] = {
            "winner": winner, "playout": playout,
            "winner_eval_per_s": W / (winner_t["kernel"] * 1e-3),
            "playout_eval_per_s": W / (playout_t["kernel"] * 1e-3),
            "black_wins": int((win == 1).sum())}
    return out


def run_gomoku(device, seed: int, shapes=GOMOKU_SHAPES,
               iters: int = 20) -> dict:
    out = {}
    for size, W in shapes:
        g = game_mod.make_game("gomoku", size)
        keys = playout_keys(size, W, 9000, seed, device)
        empty = g.init_board(device).expand(W, -1).contiguous()
        vals = g.playout_batch(empty, 1, keys)
        scalar = torch.stack([g.playout_scalar(empty[i], 1, keys[i])
                              for i in range(W)])
        t = ms_in_turns({"batched": lambda: g.playout_batch(empty, 1, keys)},
                        device, iters=iters)
        out[f"{size}x{size}W{W}"] = {
            "dispatch": "pytorch_body (no kernel in either package)",
            "batched_vs_scalar_agreement": float(
                (vals == scalar).float().mean()),
            "draw_fraction": float((vals == 0).float().mean()),
            "playout_batched_ms": t["batched"],
            "playout_eval_per_s": W / (t["batched"] * 1e-3)}
    return out


def run_rmsnorm(device, seed: int, shapes=RMSNORM_SHAPES,
                iters: int = 50) -> dict:
    out = {}
    for N, D in shapes:
        x, w = rmsnorm_inputs(N, D, seed, device)
        err = float((ops.rmsnorm(x, w) - ref.rmsnorm(x, w)).abs().max())
        times = ms_in_turns({
            "kernel": lambda: ops.rmsnorm(x, w),
            "plain": lambda: ref.rmsnorm(x, w),
            "library": lambda: F.rms_norm(x, (D,), w, 1e-5)}, device,
            iters=iters)
        n_bytes = 4 * (2 * N * D + D)
        e = _entry(device, times, err, RMSNORM_TOL,
                   bound_ms(n_bytes, 4 * N * D))
        e.update(body=(rmsnorm_body(x.dtype, D) if device.type == "cuda"
                       else None), dtype="float32",
                 gbps=n_bytes / (times["kernel"] * 1e-3) / 1e9)
        out[f"{N}x{D}"] = e
    return out


def run(seed: int = 0, device=None, flash_shapes=FLASH_SHAPES,
        uct_shapes=UCT_SHAPES, hex_shapes=HEX_SHAPES,
        gomoku_shapes=GOMOKU_SHAPES, rmsnorm_shapes=RMSNORM_SHAPES,
        iters: int = 50) -> dict:
    device = resolve_device(device)
    out = {
        "device": device_stamp(device),
        "flash_attention": run_flash(device, seed, flash_shapes,
                                     iters=iters),
        "uct_select": run_uct(device, seed, uct_shapes, iters=iters),
        "hex_winner": run_hex(device, seed, hex_shapes, iters=iters),
        "gomoku_eval": run_gomoku(device, seed, gomoku_shapes,
                                  iters=max(1, iters // 2)),
        "rmsnorm": run_rmsnorm(device, seed, rmsnorm_shapes, iters=iters),
    }
    out["playout_eval_per_s"] = max(
        e["playout_eval_per_s"] for e in out["hex_winner"].values())
    return out


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device; default: cuda")
    args = p.parse_args(argv)
    out = run(device=args.device)
    print(json.dumps(out, indent=1))
    print("->", save_result("kernels_micro", out))
    return out


if __name__ == "__main__":
    main()
