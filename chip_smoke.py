#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc``, holds each against its plain PyTorch version on the card,
and drives the port's two paths:

- one full-width GSCPM Hex search (11x11, 256 lanes, the paper's 1,048,576
  playouts) through ``repro_torch.core.gscpm.gscpm_search``, checking among
  other things that the same search run twice (at 65,536 playouts) gives
  bit-identical trees;
- GSCPM-guided decoding on SmolLM-135M at its published width (random
  weights from seed 0): ``repro_torch.serve.mcts_decode.mcts_generate`` of 4
  tokens after a 128-token prompt, 1,024 playouts on 64 lanes per token,
  run twice with bit-identical tokens and trees, then once more, and one
  search stepped side by side, with the kernels' plain versions.

Each phase prints one JSON line; any failed check ends the run with a
non-zero exit code. Without a GPU it exits non-zero and prints no result.

The last line is ``{"ok": true, "device": {...}}``; the line before it has
the card's name and power limit; the line before that is the
``{"kernels": [...]}`` record with every kernel's time, bound and launches
on its path (each path's counters are zeroed just before it runs).
"""

from __future__ import annotations

import argparse
import importlib.metadata
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet). A kernel's bound is
# the larger of bytes / memory rate and operations / rate; the integer and
# float32 work of these kernels runs outside the tensor cores, so the rate
# is the 67 T/s float32 figure.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# the same sheet's dense bf16 tensor-core rate: the rate for attention's
# products on bf16 inputs
BF16_TENSOR_OPS_PER_S = 989e12

# the paper's configuration: 11x11 Hex, 256 lanes, 1024 tasks, fifo, Cp = 1
FULL = dict(board_size=11, n_workers=256, n_tasks=1024, tree_cap=1 << 18,
            scheduler="fifo", cp=1.0, vl_rounds=1)
# the paper's budget; 65,536 playouts with tree_cap 1 << 18 is the cut-down
# run (`--playouts 65536`) for when the time limit is short
PAPER_PLAYOUTS = 1_048_576
SHORT_PLAYOUTS = 65_536

# the LM path: SmolLM-135M at full width, one request, a 128-token prompt,
# 4 generated tokens, each from a GSCPM search of 1,024 playouts on 64 lanes
LM_PROMPT_LEN = 128
LM_TOKENS = 4
LM_PLAYOUTS = 1024
LM_SEARCH = dict(n_workers=64, n_tasks=64, branch=8, max_depth=6,
                 rollout_len=8, tree_cap=4096)
LM_PREFILL_SHAPE = (64, 9, 3, LM_PROMPT_LEN, 64)   # B, H, Hkv, S, d
LM_DECODE_NORM_SHAPE = (64, 576)                  # W rows of d_model
# kernel vs plain version on the card: the tolerances of the JAX package's
# own kernel tests (tests/test_kernels.py) for attention. For the norm in
# float32, where its two rounding orders are one function, one float32
# rounding of the statistics (allclose, atol = rtol). In bfloat16 the two
# orders part by a bf16 step in ~25 % of the elements, which no allclose at
# this scale can see: there at most 0.1 % of the elements may differ from
# the plain version, by at most one bf16 step in the "kernel" order (one
# rounding) and two in the "model" order (a step of the rounded normalised
# value, times a weight up to ~1.3 and rounded again); the check also makes
# sure the other order's plain output fails the 0.1 % limit.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2.5e-2}
RMSNORM_F32_TOL = 1e-5
RMSNORM_BF16_SHARE = 1e-3
RMSNORM_BF16_STEPS = {"kernel": 1, "model": 2}
# logits of the full-width bf16 model (prefill, replay and rollout decode
# steps), kernels vs plain versions: both round the same values to bf16 in
# 61 norms and 30 attentions, where a one-ulp difference (2**-8 relative)
# can flip; allowed: 5 % of the largest logit
LOGITS_TOL = 0.05


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg: str) -> None:
    if not bool(cond):
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, launches: int = 50, replays: int = 20) -> float:
    """Mean milliseconds per call with the host taken out: `launches` calls
    captured into one CUDA graph, the graph replayed. What is left is the
    device's own time for one launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, iters=replays, warmup=3) / launches


# --------------------------------------------------------------- env, build ----
def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln),
                   nvcc.strip())
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = None
    emit("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=release, triton=triton, python=sys.version.split()[0])
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         compiled_now=_build.last_build_seconds is not None,
         sources=[os.path.relpath(s, HERE) for s in _build.sources()],
         flags=list(_build.NVCC_FLAGS))


# --------------------------------------------------------------------- rng ----
def phase_rng(torch) -> None:
    """The card's threefry equals jax.random's (vectors pinned from
    jax.random.key / fold_in / split / uniform, typed keys, partitionable
    threefry; tests/test_torch_rng.py holds the same values against JAX)."""
    from repro_torch import rng
    check(rng.fold_in(rng.key(0, "cuda"), 3).tolist()
          == [2467461003, 3840466878], "fold_in(key(0), 3) != jax.random")
    k7 = rng.key(7, "cuda")
    check(rng.split(k7, 3).tolist() == [[3625411723, 1954958720],
                                        [195045567, 4062205631],
                                        [966301609, 1948237315]],
          "split(key(7), 3) != jax.random")
    u = rng.uniform(k7, 4)
    check(u.view(torch.int32).tolist()
          == [1059885352, 1064927358, 1050349136, 1055084168],
          "uniform(key(7), 4) != jax.random")
    keys = rng.split(rng.key(11, "cuda"), 256)
    on_card = rng.uniform(rng.fold_in(keys, torch.arange(256, device="cuda")),
                          121)
    on_cpu = rng.uniform(rng.fold_in(keys.cpu(), torch.arange(256)), 121)
    check(torch.equal(on_card.cpu(), on_cpu), "uniform (256, 121): card != CPU")
    check(((on_card >= 0) & (on_card < 1)).all(), "uniform outside [0, 1)")
    # first-index argmax on the card, at the shapes the search relies on
    ties = torch.zeros((256, 121), device="cuda")
    ties[:, 40:] = 3.0
    check((torch.argmax(ties, dim=-1) == 40).all(),
          "torch.argmax on the card does not return the first maximum")
    # and at the LM path's (lanes, vocab) rows: argmax, and the stable sort
    # that gives lax.top_k's order of tied logits
    from repro_torch.serve.mcts_decode import top_k_tokens
    vocab_ties = torch.zeros((64, 49_152), device="cuda")
    vocab_ties[:, 1000::7] = 2.0
    check((torch.argmax(vocab_ties, dim=-1) == 1000).all(),
          "torch.argmax on (64, 49152) does not return the first maximum")
    check((top_k_tokens(vocab_ties, 8)
           == torch.arange(1000, 1056, 7, device="cuda")).all(),
          "top_k_tokens on the card does not order ties by token id")
    g_card = rng.gumbel(rng.split(rng.key(3, "cuda"), 64), 49_152).cpu()
    g_cpu = rng.gumbel(rng.split(rng.key(3, "cpu"), 64), 49_152)
    gumbel_err = float((g_card - g_cpu).abs().max())
    check(gumbel_err < 1e-5,
          f"gumbel (64, 49152): card and CPU part by {gumbel_err}, more "
          "than log's rounding")
    emit("rng", ok=True, pinned=["fold_in", "split", "uniform"],
         card_equals_cpu=True, argmax_first_index=True,
         top_k_ties_by_token_id=True, gumbel_card_vs_cpu_max_abs=gumbel_err)


# ----------------------------------------------------------------- kernels ----
def uct_case(torch, W, C, noise, mask, seed):
    """Integer-valued stats with unvisited slots, invalid tails and one
    fully masked row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g, device="cuda")
    visits = torch.round(r(W, C) * 10)
    wins = torch.round(r(W, C) * visits)
    vloss = torch.round(r(W, C) * 2) * (r(W, C) < 0.3)
    n_kids = torch.randint(0, C + 1, (W,), generator=g, device="cuda")
    valid = torch.arange(C, device="cuda")[None, :] < n_kids[:, None]
    ptot = torch.clamp((visits * valid).sum(-1), min=1.0)
    nz = 1e-3 * r(W, C) if noise else None
    lm = None
    if mask:
        lm = r(W) > 0.25
        lm[W // 2] = False
    else:
        valid[W // 2] = False     # a fully invalid row either way
    return (wins, visits, vloss, ptot, valid), nz, lm


def check_uct_select(torch):
    from repro_torch.kernels import ref, uct_select as us
    from repro_torch import parity
    rows = mismatches = below = 0
    worst = 0
    for W, C in [(256, 121), (256, 8), (7, 5)]:
        for noise in (False, True):
            for mask in (False, True):
                for cp in (1.0, 0.35):
                    args, nz, lm = uct_case(torch, W, C, noise, mask,
                                            seed=W * C + 2 * noise + mask)
                    got = us.uct_select(*args, cp, noise=nz, lane_mask=lm)
                    want = ref.uct_select(*args, cp, noise=nz, lane_mask=lm)
                    torch.cuda.synchronize()
                    check(got.dtype == torch.int32 and got.shape == (W,),
                          "uct_select: wrong output type or shape")
                    diff = got != want
                    if noise:
                        gap = parity.top_two_gap(*args, cp, noise=nz,
                                                 lane_mask=lm)
                        clear = gap > parity.TIE_GAP
                        below += int((~clear).sum())
                        diff = diff & clear
                    bad = int(diff.sum())
                    mismatches += bad
                    rows += W
                    if bad:
                        worst = max(worst, int((got - want).abs()[diff].max()))
    check(mismatches == 0,
          f"uct_select: {mismatches} picks differ from the plain version "
          f"on rows with a top-two gap above {parity.TIE_GAP}")
    return {"rows": rows, "mismatches": mismatches,
            "rows_below_tie_gap": below, "max_abs_err": worst}


def adversarial_boards(torch, size):
    """All-black, all-white, and black solid / comb / snake on white: the
    long thin components that need the most pointer-doubling rounds."""
    n = size * size
    comb = torch.zeros(n, dtype=torch.bool)
    snake = torch.zeros(n, dtype=torch.bool)
    for r in range(size):
        for c in range(size):
            if c % 2 == 0 or r == 0:
                comb[r * size + c] = True
            if r % 2 == 0 or c == size - 1:
                snake[r * size + c] = True
    stones = torch.stack([torch.ones(n, dtype=torch.bool),
                          torch.zeros(n, dtype=torch.bool), comb, snake,
                          snake.reshape(size, size).T.reshape(-1)])
    return torch.where(stones, 1, 2).to(torch.int8).cuda()


def check_hex_winner(torch):
    from repro_torch.core import hex as hx
    from repro_torch.kernels import hex_winner as hw, ref
    boards_checked = mismatches = 0
    for size in (2, 5, 7, 11, 13, 19):
        n = size * size
        g = torch.Generator(device="cuda").manual_seed(size)
        rand = (torch.randint(1, 3, (256, n), generator=g, device="cuda")
                .to(torch.int8))
        boards = torch.cat([rand, adversarial_boards(torch, size)])
        got = hw.hex_winner(boards, size)
        torch.cuda.synchronize()
        want = ref.hex_winner(boards, size)
        flood = hx.winner_flood_batch(boards, hx.HexSpec(size))
        check(got.dtype == torch.int8 and got.shape == (boards.shape[0],),
              "hex_winner: wrong output type or shape")
        check(torch.equal(want, flood),
              f"hex_winner size {size}: plain version != flood fill")
        mismatches += int((got != want).sum())
        boards_checked += boards.shape[0]
    check(mismatches == 0,
          f"hex_winner: {mismatches} winners differ from the plain version")
    return {"boards": boards_checked, "mismatches": 0, "max_abs_err": 0}


def phase_kernels(torch):
    """Hold both kernels against their plain versions on the card, then time
    them at the shapes the main path gives them."""
    from repro_torch.core import hex as hx
    from repro_torch.core.hex import doubling_rounds
    from repro_torch.kernels import hex_winner as hw, ref, uct_select as us

    uct = check_uct_select(torch)
    hexw = check_hex_winner(torch)

    W, C = FULL["n_workers"], FULL["board_size"] ** 2
    args, nz, lm = uct_case(torch, W, C, True, True, seed=1)
    uct_call = lambda: us.uct_select(*args, 1.0, noise=nz, lane_mask=lm)
    uct_ms = time_ms(uct_call)
    uct_graph = graph_ms(uct_call)
    uct_plain = time_ms(
        lambda: ref.uct_select(*args, 1.0, noise=nz, lane_mask=lm), iters=50)
    # each input read once, the output written once
    uct_bytes = 4 * W * C * 4 + W * C + W * 4 + W + W * 4
    uct_ops = 12 * W * C           # score (~9 flops) + compare/select per slot
    uct_bound = max(uct_bytes / HBM_BYTES_PER_S, uct_ops / OPS_PER_S) * 1e3

    size = FULL["board_size"]
    g = torch.Generator(device="cuda").manual_seed(0)
    boards = (torch.randint(1, 3, (W, C), generator=g, device="cuda")
              .to(torch.int8))
    hex_ms = time_ms(lambda: hw.hex_winner(boards, size))
    hex_graph = graph_ms(lambda: hw.hex_winner(boards, size))
    hex_plain = time_ms(lambda: ref.hex_winner(boards, size), iters=10,
                        warmup=2)
    flood_ms = time_ms(
        lambda: hx.winner_flood_batch(boards, hx.HexSpec(size)), iters=10,
        warmup=2)
    hex_bytes = W * C + W
    # per round and cell: 6 neighbour tests and mins, 2 atomic mins, 1 jump
    hex_ops = W * C * doubling_rounds(C) * 20
    hex_bound = max(hex_bytes / HBM_BYTES_PER_S, hex_ops / OPS_PER_S) * 1e3

    records = [
        {"name": "uct_select", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/uct_select.cu",
         "replaces": "src/repro/kernels/uct_select.py:36",
         "shape": [W, C], "checked": uct, "max_abs_err": uct["max_abs_err"],
         "ms": uct_ms, "in_graph_ms": uct_graph, "plain_ms": uct_plain, "bound_ms": uct_bound,
         "bound_by": "bytes" if uct_bytes / HBM_BYTES_PER_S
         >= uct_ops / OPS_PER_S else "operations",
         "library_ms": None},
        {"name": "hex_winner", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hex_winner.cu",
         "replaces": "src/repro/kernels/hex_winner.py:46",
         "shape": [W, C], "checked": hexw, "max_abs_err": 0,
         "ms": hex_ms, "in_graph_ms": hex_graph, "plain_ms": hex_plain, "bound_ms": hex_bound,
         "bound_by": "bytes" if hex_bytes / HBM_BYTES_PER_S
         >= hex_ops / OPS_PER_S else "operations",
         "library_ms": None, "flood_fill_ms": flood_ms},
    ]
    emit("kernels_checked", uct_select=uct, hex_winner=hexw,
         note="both bounds are far below one launch's latency: at these "
              "shapes the kernels are launch-bound")
    return records


# ------------------------------------------------------------------ search ----
def count_launches_one_iteration(torch, tree, board, cfg, key):
    """CUDA kernel launches of ONE sync iteration on `tree` (which it
    advances), by torch.profiler; None if the profiler saw no device
    activity."""
    from repro_torch import rng
    from repro_torch.core import gscpm
    from torch.profiler import ProfilerActivity, profile
    W = cfg.n_workers
    task_keys = gscpm.fold_task_keys(
        key, torch.arange(10_000, 10_000 + W, dtype=torch.int32, device="cuda"))
    active = torch.ones(W, dtype=torch.bool, device="cuda")
    iter_keys = rng.fold_in(task_keys, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gscpm.sync_iteration(tree, board, cfg, cfg.cp, iter_keys, active)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    kernels = 0
    device_us = 0.0
    host_launches = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            if not ev.name.startswith(("Memcpy", "Memset")):
                kernels += 1
                device_us += float(getattr(ev, "device_time", 0.0) or 0.0)
        elif ev.name in ("cudaLaunchKernel", "cuLaunchKernel",
                         "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            host_launches += 1
    if kernels == 0:
        # no device trace: the host-side launch calls are the count
        return (host_launches or None), None
    return kernels, device_us / 1e3


def phase_search(torch, n_playouts: int):
    from repro_torch import parity, rng
    from repro_torch.core import scheduler as sched
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    from repro_torch.core.tree import check_invariants
    from repro_torch.kernels import hex_winner as hw, uct_select as us

    cap = FULL["tree_cap"] if n_playouts <= SHORT_PLAYOUTS else 1 << 20
    cfg = GSCPMConfig(**{**FULL, "tree_cap": cap}, n_playouts=n_playouts)
    game = cfg.game_obj
    board = game.init_board("cuda")
    key = rng.key(0, "cuda")
    iterations = sum(r.m for r in sched.make_schedule(
        cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler))

    # warm the allocator and every torch op on a short search first
    gscpm_search(board, 1, GSCPMConfig(**FULL, n_playouts=2048), key)

    # the same full-width search twice, at the cut-down budget: atomics add
    # only 0, 0.5 and 1, so the two trees must be bit-identical
    short = GSCPMConfig(**FULL, n_playouts=SHORT_PLAYOUTS)
    short_iters = sum(r.m for r in sched.make_schedule(
        short.n_playouts, short.n_tasks, short.n_workers, short.scheduler))
    us.uct_select.launches = 0
    tree_a, st_a = gscpm_search(board, 1, short, key)
    short_levels = us.uct_select.launches / short_iters
    tree_b, st_b = gscpm_search(board, 1, short, key)
    fields = parity.differing_fields(tree_a, tree_b)
    check(fields == [],
          f"the same search run twice gave different trees: {fields}")
    check(float(tree_a.visits[0]) == SHORT_PLAYOUTS, "short search: root visits")
    emit("search_twice", config={**FULL, "n_playouts": SHORT_PLAYOUTS},
         bit_identical=True,
         playouts_per_s=[st_a["playouts_per_s"], st_b["playouts_per_s"]],
         ms_per_sync_iteration=[1e3 * st_a["time_s"] / short_iters,
                                1e3 * st_b["time_s"] / short_iters],
         mean_descent_levels=short_levels, tree_nodes=st_a["tree_nodes"])
    del tree_a, tree_b

    # the main path: counts to 0 just before, read just after
    us.uct_select.launches = 0
    hw.hex_winner.launches = 0
    tree, st = gscpm_search(board, 1, cfg, key)
    launches = {"uct_select": us.uct_select.launches,
                "hex_winner": hw.hex_winner.launches}

    check(st["playouts"] == n_playouts, "playout count differs from the budget")
    check(float(tree.visits[0]) == n_playouts,
          f"root visits {float(tree.visits[0])} != playouts {n_playouts}")
    check_invariants(tree)
    check(launches["uct_select"] > 0, "uct_select kernel never launched")
    check(launches["hex_winner"] == iterations,
          f"hex_winner launches {launches['hex_winner']} != sync iterations "
          f"{iterations}")
    check(torch.isfinite(tree.wins).all() and torch.isfinite(tree.visits).all(),
          "non-finite tree statistics")
    check(0 <= st["best_move"] < game.n_cells, "best move off the board")

    n_kernels, dev_ms = count_launches_one_iteration(torch, tree, board, cfg,
                                                     key)
    rate = st["playouts_per_s"]
    emit("search", config={**FULL, "tree_cap": cap, "n_playouts": n_playouts},
         playouts_per_s=rate, seconds=st["time_s"],
         sync_iterations=iterations,
         ms_per_sync_iteration=1e3 * st["time_s"] / iterations,
         mean_descent_levels=launches["uct_select"] / iterations,
         launches=launches, tree_nodes=st["tree_nodes"],
         best_move=st["best_move"], root_value=st["root_value"],
         cuda_kernels_in_one_iteration=n_kernels,
         device_ms_in_one_iteration=dev_ms,
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20)

    # kernels vs plain versions, whole small search, both on the card
    small = GSCPMConfig(board_size=7, n_workers=16, n_tasks=16,
                        n_playouts=1024, tree_cap=4096)
    b7 = small.game_obj.init_board("cuda")
    k7 = rng.key(5, "cuda")
    t_kernel, _ = gscpm_search(b7, 1, small, k7)
    t_plain, _ = gscpm_search(b7, 1, small, k7, plain_kernels=True)
    fields = parity.differing_fields(t_kernel, t_plain)
    explained = None
    if fields:
        explained = explain_divergence(torch, small, b7, k7)
    emit("search_kernel_vs_plain", config="hex 7x7, W=16, 1024 playouts",
         trees_equal=not fields, differing_fields=fields,
         first_divergent_pick=explained)
    return launches, rate


def explain_divergence(torch, cfg, board, key):
    """Step the kernel-driven and the plain-driven search side by side; at
    the first sync iteration after which the trees differ, find the pick
    that differs and require its top-two score gap to be under the tie
    threshold. Anything else is a failure."""
    from repro_torch import parity
    from repro_torch.core import gscpm
    from repro_torch.core.tree import init_tree
    from repro_torch.kernels import ops, ref
    a = init_tree(cfg.tree_cap, cfg.game_obj.n_actions, 1, device="cuda")
    b = parity.clone_tree(a)
    for it, (iter_keys, active) in enumerate(parity.iteration_plan(cfg, key)):
        before = parity.clone_tree(a)
        gscpm.sync_iteration(a, board, cfg, cfg.cp, iter_keys, active)
        with ops.plain_versions():
            gscpm.sync_iteration(b, board, cfg, cfg.cp, iter_keys, active)
        if parity.differing_fields(a, b):
            pick = parity.first_divergent_pick(
                before, board, cfg, cfg.cp, iter_keys, ref.uct_select)
            check(pick is not None,
                  f"trees differ after sync iteration {it} but no pick does")
            check(pick["gap"] < parity.TIE_GAP,
                  f"kernel and plain version part at a pick with a clear "
                  f"gap: {pick}")
            return {"sync_iteration": it, **pick}
    raise SystemExit("chip_smoke: FAILED: whole searches differ but stepping "
                     "them side by side found no difference")


def phase_sequential(torch, n_playouts: int):
    from repro_torch import rng
    from repro_torch.core.mcts import uct_search
    from repro_torch.core.tree import check_invariants
    board = torch.zeros(121, dtype=torch.int8, device="cuda")
    tree, st = uct_search(board, 1, n_playouts, rng.key(0, "cuda"),
                          board_size=11, tree_cap=1 << 14)
    check(float(tree.visits[0]) == n_playouts, "sequential: root visits")
    check_invariants(tree)
    emit("sequential", config="uct_search, hex 11x11, one lane",
         playouts=n_playouts, playouts_per_s=st["playouts_per_s"],
         seconds=st["time_s"], tree_nodes=st["tree_nodes"])
    return st["playouts_per_s"]


# -------------------------------------------------------------- LM kernels ----
def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    """(bound in ms, what bounds it) for `n_bytes` moved and `n_ops` done."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def check_flash(torch):
    """The flash kernel against its plain version on the card: the prefill
    shape, GQA, MQA, head dims 64/80/128, causal or not, float32 and
    bfloat16, sequence lengths off the tile size, and the model's strided
    (B, S, H, d) layout through ops."""
    from repro_torch.kernels import flash_attention as fa, ops, ref
    cases = [  # B, H, Hkv, S, d
        (64, 9, 3, 128, 64), (2, 4, 2, 128, 64), (1, 8, 1, 128, 128),
        (2, 2, 2, 128, 80), (2, 4, 2, 129, 64), (3, 6, 2, 200, 64),
        (1, 2, 1, 1, 64), (2, 4, 4, 37, 32)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for i, (B, H, Hkv, S, d) in enumerate(cases):
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                g = torch.Generator(device="cuda").manual_seed(i)
                r = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dt)
                q, k, v = r(B, H, S, d), r(B, Hkv, S, d), r(B, Hkv, S, d)
                got = fa.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention(q, k, v, causal=causal)
                # the model's layout: strided views in, (B, S, H, d) out
                got_bshd = ops.flash_attention(
                    *(t.transpose(1, 2) for t in (q, k, v)), causal=causal)
                torch.cuda.synchronize()
                name = "float32" if dt == torch.float32 else "bfloat16"
                tol = FLASH_TOL[name]
                err = float((got.float() - want.float()).abs().max())
                check(got.dtype == dt and got.shape == q.shape,
                      "flash_attention: wrong output type or shape")
                check(torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol),
                      f"flash_attention {(B, H, Hkv, S, d)} {name} causal="
                      f"{causal}: max abs err {err} above {tol}")
                check(torch.equal(got_bshd.transpose(1, 2), got),
                      "flash_attention: the strided bshd call differs")
                worst[name] = max(worst[name], err)
                n += 1
    return {"cases": n, "tolerance": FLASH_TOL, "max_abs_err": worst}


def bf16_steps(torch, a, b):
    """Per element, how many bfloat16 steps apart ``a`` and ``b`` lie."""
    def ordinal(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordinal(a) - ordinal(b)).abs()


def check_rmsnorm(torch):
    """The rmsnorm kernel against its plain version on the card, both
    rounding orders, D = 576, 1024 and an odd D, float32 and bfloat16 (see
    RMSNORM_* for the limits)."""
    from repro_torch.kernels import ref, rmsnorm as rn
    worst = {"float32": 0.0, "bfloat16": 0.0}
    share = steps = 0.0
    other_share = 1.0
    n = 0
    for D in (576, 1024, 577):
        for N in (64, 64 * 128, 7):
            for dt in (torch.float32, torch.bfloat16):
                for wdt in (torch.float32, torch.bfloat16):
                    for order in ("kernel", "model"):
                        g = torch.Generator(device="cuda").manual_seed(D + N)
                        x = (3 * torch.randn(N, D, generator=g,
                                             device="cuda")).to(dt)
                        w = (1 + 0.1 * torch.randn(D, generator=g,
                                                   device="cuda")).to(wdt)
                        got = rn.rmsnorm(x, w, 1e-5, order=order)
                        want = ref.rmsnorm(x, w, 1e-5, order=order)
                        torch.cuda.synchronize()
                        name = "float32" if dt == torch.float32 else "bfloat16"
                        case = f"rmsnorm D={D} N={N} {name} w {wdt} {order}"
                        err = float((got.float() - want.float()).abs().max())
                        check(got.dtype == dt and got.shape == x.shape,
                              "rmsnorm: wrong output type or shape")
                        worst[name] = max(worst[name], err)
                        n += 1
                        if dt == torch.float32:
                            tol = RMSNORM_F32_TOL
                            check(torch.allclose(got, want, atol=tol,
                                                 rtol=tol),
                                  f"{case}: max abs err {err} above {tol}")
                            continue
                        apart = bf16_steps(torch, got, want)
                        s = float((apart > 0).float().mean())
                        check(s <= RMSNORM_BF16_SHARE
                              and int(apart.max()) <= RMSNORM_BF16_STEPS[order],
                              f"{case}: {s:.4%} of elements differ, up to "
                              f"{int(apart.max())} bf16 steps")
                        share, steps = max(share, s), max(steps, int(apart.max()))
                        # a kernel with the other order would fail the limit
                        wrong = ref.rmsnorm(x, w, 1e-5, order={
                            "kernel": "model", "model": "kernel"}[order])
                        o = float((bf16_steps(torch, wrong, want) > 0)
                                  .float().mean())
                        check(o > RMSNORM_BF16_SHARE,
                              f"{case}: the other order's output passes the "
                              f"limit ({o:.4%} of elements differ)")
                        other_share = min(other_share, o)
    return {"cases": n, "max_abs_err": worst,
            "tolerance": {
                "float32": f"allclose, atol = rtol = {RMSNORM_F32_TOL}",
                "bfloat16": f"at most {RMSNORM_BF16_SHARE:.1%} of elements "
                            "differ, by at most "
                            f"{RMSNORM_BF16_STEPS['kernel']} ('kernel' order) "
                            f"or {RMSNORM_BF16_STEPS['model']} ('model') bf16 "
                            "steps"},
            "bfloat16_share_differing_max": share,
            "bfloat16_steps_max": steps,
            "other_order_share_differing_min": other_share}


def phase_lm_kernels(torch):
    """Hold the two LM kernels against their plain versions on the card,
    then time them at the shapes the LM path gives them: flash attention at
    the prefill (64 lanes, 9 heads over 3 KV heads, 128 tokens, d=64, bf16,
    the model's strided layout), rmsnorm at the decode step (64 x 576 bf16,
    the model's rounding order)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    flash = check_flash(torch)
    norm = check_rmsnorm(torch)

    B, H, Hkv, S, d = LM_PREFILL_SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    q = torch.randn(B, S, H, d, generator=g, device="cuda").to(bf)
    k = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(bf)
    v = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(bf)
    fa_call = lambda: ops.flash_attention(q, k, v, causal=True)
    fa_ms, fa_graph = time_ms(fa_call), graph_ms(fa_call)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    fa_plain = time_ms(lambda: ref.flash_attention(qh, kh, vh, causal=True),
                       iters=20, warmup=3)
    qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
    fa_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True))
    lib_out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                             enable_gqa=True)
    fa_lib_err = float((lib_out.transpose(1, 2).float()
                        - fa_call().float()).abs().max())
    # each input read once, the output written once; the causal pairs only
    fa_bytes = 2 * (2 * B * H * S * d + 2 * B * Hkv * S * d)
    fa_ops = 4 * B * H * (S * (S + 1) // 2) * d
    fa_bound, fa_by = bound_ms(fa_bytes, fa_ops, BF16_TENSOR_OPS_PER_S)

    N, D = LM_DECODE_NORM_SHAPE
    x = torch.randn(N, 1, D, generator=g, device="cuda").to(bf)
    w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(bf)
    rn_call = lambda: ops.rmsnorm(x, w, 1e-5, order="model")
    rn_ms, rn_graph = time_ms(rn_call), graph_ms(rn_call)
    rn_plain = time_ms(lambda: ref.rmsnorm(x, w, 1e-5, order="model"))
    rn_lib = time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5))
    rn_bytes = 2 * (2 * N * D + D)
    rn_ops = 4 * N * D            # square, add, scale, weight per element
    rn_bound, rn_by = bound_ms(rn_bytes, rn_ops, OPS_PER_S)
    # the prefill's norm shape, for the record
    xp = torch.randn(B, S, D, generator=g, device="cuda").to(bf)
    rn_prefill_ms = graph_ms(lambda: ops.rmsnorm(xp, w, 1e-5, order="model"))

    records = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:38",
         "shape": [B, H, Hkv, S, d], "dtype": "bfloat16", "layout": "bshd",
         "checked": flash, "max_abs_err": flash["max_abs_err"]["bfloat16"],
         "ms": fa_ms, "in_graph_ms": fa_graph, "plain_ms": fa_plain,
         "bound_ms": fa_bound, "bound_by": fa_by, "library_ms": fa_lib,
         "library_call": "torch.nn.functional.scaled_dot_product_attention"
                         "(is_causal=True, enable_gqa=True)",
         "library_max_abs_diff": fa_lib_err},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:19",
         "shape": [N, 1, D], "dtype": "bfloat16", "order": "model",
         "checked": norm, "max_abs_err": norm["max_abs_err"]["bfloat16"],
         "ms": rn_ms, "in_graph_ms": rn_graph, "plain_ms": rn_plain,
         "bound_ms": rn_bound, "bound_by": rn_by, "library_ms": rn_lib,
         "library_call": "torch.nn.functional.rms_norm",
         "prefill_shape": [B, S, D], "prefill_in_graph_ms": rn_prefill_ms},
    ]
    emit("lm_kernels", flash_attention=flash, rmsnorm=norm,
         timed={r["name"]: {k: r[k] for k in ("ms", "in_graph_ms", "plain_ms",
                                                "bound_ms", "bound_by",
                                                "library_ms")}
                for r in records})
    return records


# --------------------------------------------------------------- LM search ----
def lm_path_counters():
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    from repro_torch.kernels import uct_select as us
    return {"flash_attention": fa.flash_attention, "rmsnorm": rn.rmsnorm,
            "uct_select": us.uct_select}


def profile_one_lm_iteration(torch, params, mcfg, dcfg, prompt, key):
    """CUDA kernels launched, and device-busy ms, in ONE sync iteration of
    the LM search (after a prefill), by torch.profiler; fails if the
    profiler saw no device activity."""
    from repro_torch import rng
    from repro_torch.core.gscpm import fold_task_keys
    from repro_torch.core.tree import init_tree
    from repro_torch.models import api
    from repro_torch.serve import mcts_decode as md
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    W = dcfg.n_workers
    P = prompt.shape[0]
    max_len = P + dcfg.max_depth + dcfg.rollout_len + 1
    logits, cache = api.prefill(params, mcfg,
                                {"tokens": prompt[None, :].repeat(W, 1)},
                                max_len)
    root = logits[0, 0].float()
    tree = init_tree(dcfg.tree_cap, dcfg.branch, 1, device="cuda")
    keys = fold_task_keys(key, torch.arange(W, dtype=torch.int32,
                                            device="cuda"))
    active = torch.ones(W, dtype=torch.bool, device="cuda")
    # a few iterations first, so the profiled one descends a real tree
    for i in range(4):
        md._iteration(tree, params, mcfg, dcfg, cache, root, P, dcfg.cp,
                      rng.fold_in(keys, i), active)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        md._iteration(tree, params, mcfg, dcfg, cache, root, P, dcfg.cp,
                      rng.fold_in(keys, 4), active)
        torch.cuda.synchronize()
    kernels, device_us = 0, 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not ev.name.startswith(
                ("Memcpy", "Memset")):
            kernels += 1
            device_us += float(getattr(ev, "device_time", 0.0) or 0.0)
    check(kernels > 0, "torch.profiler saw no CUDA kernel in an LM iteration")
    return kernels, device_us / 1e3


def check_decode_steps(torch, params, mcfg, prompt, dcfg):
    """The model's decode step, kernels vs plain versions, on the same
    tokens: after a prefill of the prompt on W lanes each way, every replay
    and rollout position of one sync iteration (max_depth + rollout_len
    steps) with the same seeded tokens fed to both. The logits agree within
    LOGITS_TOL of the largest at every step. (A search stepped both ways
    compares decode logits only until its decisions part, which at a tied
    root top-k is before the first decode step.)"""
    import contextlib
    from repro_torch.kernels import ops
    from repro_torch.models import api
    P, W = LM_PROMPT_LEN, dcfg.n_workers
    T = dcfg.max_depth + dcfg.rollout_len
    g = torch.Generator(device="cuda").manual_seed(1)
    fed = torch.randint(0, mcfg.vocab, (W, T), generator=g, device="cuda",
                        dtype=torch.int32)
    runs = []
    for ctx in (contextlib.nullcontext, ops.plain_versions):
        with ctx():
            _, cache = api.prefill(params, mcfg,
                                   {"tokens": prompt[None, :].repeat(W, 1)},
                                   P + T + 1)
            runs.append([api.decode(params, mcfg, fed[:, t:t + 1], P + t,
                                    cache)[0][:, 0].float() for t in range(T)])
    errs = [float((a - b).abs().max()) for a, b in zip(*runs)]
    scale = max(float(b.abs().max()) for b in runs[1])
    check(max(errs) <= LOGITS_TOL * scale,
          f"decode steps: kernels vs plain max abs err {max(errs)} above "
          f"{LOGITS_TOL} x {scale}")
    return {"steps": T, "lanes": W, "max_abs_err_per_step": errs,
            "max_abs_logit": scale,
            "tolerance": f"{LOGITS_TOL} x max |logit|"}


def check_decode_vs_plain(torch, params, mcfg, prompt, dcfg, key, tokens):
    """The LM path's decoding, kernels vs plain versions on the same card.
    `mcts_generate` runs again inside `ops.plain_versions()` (the same
    prompt, key and budget), and one search runs both ways side by side,
    one sync iteration at a time (`parity.step_decode_search`): the first
    search whose committed token differs, else the first search. Its
    prefill, replay and rollout logits agree within LOGITS_TOL of the
    largest logit; every decision on which the two runs part is within the
    measured difference of the numbers it was taken on; and a committed
    token may differ only after such a parting."""
    from repro_torch import parity, rng
    from repro_torch.kernels import ops
    from repro_torch.serve.mcts_decode import mcts_generate
    P = LM_PROMPT_LEN
    with ops.plain_versions():
        plain, _ = mcts_generate(params, mcfg, prompt, LM_TOKENS, dcfg, key)
    differ = torch.nonzero(plain != tokens).flatten()
    i = int(differ[0]) - P if differ.numel() else 0
    rep = parity.step_decode_search(params, mcfg, dcfg, tokens[:P + i],
                                    rng.fold_in(key, i), ops.plain_versions)
    scale = rep["max_abs_logit"]
    for name in ("root_err", "leaf_err", "rollout_err"):
        check(rep[name] <= LOGITS_TOL * scale,
              f"LM search {name}: kernels vs plain max abs err {rep[name]} "
              f"above {LOGITS_TOL} x {scale}")
    check(not rep["unexcused"],
          "LM search: kernels and plain versions part at decisions their "
          f"measured error does not explain: {rep['unexcused'][:3]}")
    check(rep["best_tokens"] == [int(tokens[P + i]), int(plain[P + i])],
          f"search {i} stepped ends on {rep['best_tokens']}, mcts_generate "
          f"committed {[int(tokens[P + i]), int(plain[P + i])]}")
    check(differ.numel() == 0 or rep["parted_at"] is not None,
          f"committed token {i} differs, yet the stepped search never parted")
    return {"tokens_kernels": tokens[P:].tolist(),
            "tokens_plain": plain[P:].tolist(),
            "tokens_equal": differ.numel() == 0, "stepped_search": i,
            "tolerance": f"logits {LOGITS_TOL} x max |logit|; a parting "
                         "decision's margins within 2 x the measured "
                         "difference of its numbers",
            **{k: v for k, v in rep.items() if k != "unexcused"}}


def phase_lm_search(torch):
    """SmolLM-135M at its published width (30 layers, d=576, 9 heads over 3
    KV heads, vocab 49,152, bf16, flash prefill), random weights from seed
    0: `mcts_generate` of LM_TOKENS tokens after a 128-token prompt, run
    twice (tokens and every search's tree bit-identical), with launch
    counters, invariants, timings, a profiled iteration, and the decoding
    held against the plain versions (`check_decode_steps`,
    `check_decode_vs_plain`)."""
    from repro_torch import parity, rng
    from repro_torch.configs import get_config
    from repro_torch.core.tree import check_invariants
    from repro_torch.models import api
    from repro_torch.serve.mcts_decode import MCTSDecodeConfig, mcts_generate
    mcfg = get_config("smollm-135m").replace(use_flash=True)
    t_init = time.perf_counter()
    params = api.init_params(mcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, mcfg.vocab, (LM_PROMPT_LEN,), generator=g,
                           device="cuda", dtype=torch.int32)
    n_tokens, n_playouts = LM_TOKENS, LM_PLAYOUTS
    dcfg = MCTSDecodeConfig(**{**LM_SEARCH, "n_playouts": n_playouts})
    key = rng.key(0, "cuda")

    # warm the allocator, cuBLAS and the kernels on a short search
    mcts_generate(params, mcfg, prompt, 1,
                  MCTSDecodeConfig(**{**LM_SEARCH, "n_playouts": 64}), key)

    counters = lm_path_counters()
    for c in counters.values():
        c.launches = 0   # the LM path's counts: zeroed just before
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks_a, st_a = mcts_generate(params, mcfg, prompt, n_tokens, dcfg, key,
                                 keep_trees=True)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    toks_b, st_b = mcts_generate(params, mcfg, prompt, n_tokens, dcfg, key,
                                 keep_trees=True)
    check(torch.equal(toks_a, toks_b), "LM search: tokens differ run to run")
    for a, b in zip(st_a, st_b):
        fields = parity.differing_fields(a["tree"], b["tree"])
        check(fields == [], f"LM search: trees differ run to run in {fields}")
    new = toks_a[LM_PROMPT_LEN:]
    check(new.shape == (n_tokens,) and bool(((new >= 0)
                                            & (new < mcfg.vocab)).all()),
          f"LM search: generated tokens out of range: {new.tolist()}")
    iters = sum(s["sync_iterations"] for s in st_a)
    for i, s in enumerate(st_a):
        t = s["tree"]
        check_invariants(t, discrete_credits=False)
        check(float(t.visits[0]) == s["playouts"] == n_playouts,
              f"LM search: root visits {float(t.visits[0])} != playouts")
        check(bool(torch.isfinite(t.wins).all()), "LM search: non-finite wins")
        check(s["best_token"] == int(toks_a[LM_PROMPT_LEN + i]),
              "LM search: committed token is not the best root child")
    L = mcfg.n_layers
    steps = iters * (dcfg.max_depth + dcfg.rollout_len)
    check(launches["flash_attention"] == n_tokens * L,
          f"flash_attention launches {launches['flash_attention']} != "
          f"{n_tokens} prefills x {L} layers")
    check(launches["rmsnorm"] == (2 * L + 1) * (n_tokens + steps),
          f"rmsnorm launches {launches['rmsnorm']} != 61 x (prefills + "
          f"decode steps)")
    check(launches["uct_select"] > 0, "uct_select never launched on the LM path")

    # one decode step on its own, at the search's shape
    W = dcfg.n_workers
    max_len = LM_PROMPT_LEN + dcfg.max_depth + dcfg.rollout_len + 1
    _, cache = api.prefill(params, mcfg,
                           {"tokens": prompt[None, :].repeat(W, 1)}, max_len)
    tok = prompt[:W].reshape(W, 1)
    step = lambda: api.decode(params, mcfg, tok, LM_PROMPT_LEN, cache)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t1) * 100
    del cache

    n_kernels, dev_ms = profile_one_lm_iteration(torch, params, mcfg, dcfg,
                                                 prompt, key)
    decode_steps = check_decode_steps(torch, params, mcfg, prompt, dcfg)
    vs_plain = check_decode_vs_plain(torch, params, mcfg, prompt, dcfg, key,
                                     toks_a)
    search_s = sum(s["time_s"] for s in st_a)
    prefill_s = [s["prefill_s"] for s in st_a]
    emit("lm_search",
         config={"model": "smollm-135m", "n_params": api.n_params(mcfg),
                 "use_flash": True, "prompt_len": LM_PROMPT_LEN,
                 "n_tokens": n_tokens, **LM_SEARCH, "n_playouts": n_playouts,
                 "weights": "random, seed 0"},
         tokens=new.tolist(), run_twice_bit_identical=True,
         seconds_generate=wall_a, seconds_search=search_s,
         init_params_s=init_s,
         prefill_ms=[1e3 * p for p in prefill_s],
         sync_iterations=iters,
         ms_per_sync_iteration=1e3 * search_s / iters,
         ms_per_decode_step=decode_ms,
         playouts_per_s=n_tokens * n_playouts / search_s,
         tokens_per_s=n_tokens / wall_a,
         tree_nodes=[s["tree_nodes"] for s in st_a],
         launches=launches,
         mean_descent_levels=launches["uct_select"] / iters,
         cuda_kernels_in_one_iteration=n_kernels,
         device_ms_in_one_iteration=dev_ms,
         peak_memory_mb=peak_mb, decode_steps_vs_plain=decode_steps,
         kernels_vs_plain=vs_plain)
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--playouts", type=int, default=PAPER_PLAYOUTS,
                   help="budget of the full-width search")
    p.add_argument("--sequential-playouts", type=int, default=2048)
    p.add_argument("--only-kernels", action="store_true",
                   help="stop after the build and the kernel checks")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script measures the port on "
              "a GPU and does not fall back to the CPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails here if the port is missing)

    t0 = time.perf_counter()
    smi = phase_env(torch)
    phase_build()
    phase_rng(torch)
    records = phase_kernels(torch) + phase_lm_kernels(torch)
    if args.only_kernels:
        for r in records:
            r["launches"] = 0
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    launches, rate = phase_search(torch, args.playouts)
    seq_rate = phase_sequential(torch, args.sequential_playouts)
    lm_launches = phase_lm_search(torch)
    for r in records:
        # each kernel's count from its own path: the Hex search for
        # uct_select and hex_winner, the LM search for the LM kernels
        r["launches"] = launches.get(r["name"], lm_launches.get(r["name"]))
        r["launches_by_path"] = {
            "hex_search": launches.get(r["name"], 0),
            "lm_search": lm_launches.get(r["name"], 0)}
    emit("summary", seconds=round(time.perf_counter() - t0, 1),
         search_playouts_per_s=rate, sequential_playouts_per_s=seq_rate)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
