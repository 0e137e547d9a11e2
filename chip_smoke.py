#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (printing ``ptxas``'s registers, shared memory and spill bytes
for each), holds each against its plain PyTorch version on the card — the
Hex path's ``select_descent`` (a whole selection round in one launch) and
``hex_playout`` (a whole playout in one launch), the one-tile
``uct_select`` and ``hex_winner``, both bodies of ``flash_attention``, the
bf16 tensor-core one and the CUDA-core one, and ``rmsnorm`` — and drives
the port's four paths:

- one full-width GSCPM Hex search (11x11, 256 lanes, the paper's 1,048,576
  playouts) through ``repro_torch.core.gscpm.gscpm_search``, checking among
  other things that it launches ``select_descent`` once per selection round
  and ``hex_playout`` once per sync iteration (and the one-tile kernels
  never), and that the same search run twice (at 65,536 playouts) gives
  bit-identical trees;
- the paper's grain-size experiment at that width (``paper_sweep``): 11x11
  Hex, 65,536 playouts a point, fifo and rebalance at 64 to 4,096 tasks
  and one task a lane, each point's speedup over the sequential searcher,
  its tree's invariants and its root visits; then the device counters
  (``search_metrics``: metrics on == off bit for bit, single tree and
  forest, the counters conserved and equal with the plain versions) and
  the traced dispatch fit (``trace_fit``: ``gscpm_round`` spans at three
  grains, an identifiable fit of the card's per-round and per-iteration
  cost, no kernel build inside a span);
- the root-parallel forest (``repro_torch.core.root_parallel.
  gscpm_search_batch``): 8 trees of 32 lanes on 11x11 Hex, three self-play
  moves (131,072 playouts a member, then ``reroot_forest`` at the visit-sum
  move and two warm moves of 32,768), checking that each sync iteration
  launches ``select_descent`` once per selection round and ``hex_playout``
  once for all members, the re-root retention contract on every member
  after every move, and at 8,192 playouts a member that each member equals
  ``gscpm_search`` with its member key, that kernels equal the plain
  versions and that the forest run twice is bit-identical;
- Gomoku on the 15x15 board: a 65,536-playout search on 256 lanes, then
  ``reroot_tree`` and a warm second move, its descent through
  ``select_descent`` (225 children a node), kernels against plain versions,
  and a won position that must stop the descent;
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
on its path (each path's counters are zeroed just before it runs);
``flash_attention``'s record gives each body's time and launches under
``bodies``, and every library yardstick is timed eagerly and in a CUDA
graph.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.metadata
import json
import math
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
# CUDA kernels one profiled Hex sync iteration may launch: the descent and
# the playout are one launch each, the rest (threefry, proposal, expansion,
# backup) ~500 eager ops; the same bound holds a forest's iteration (one
# pass for all members)
MAX_KERNELS_PER_ITERATION = 800

# the paper's grain-size experiment (Fig 7) at the card's width: 65,536
# playouts a point, fifo and rebalance at these task counts, and one task a
# lane (one_per_core); the trace fit's three grains, fifo
PAPER_SWEEP_TASKS = (64, 256, 1024, 4096)
TRACE_FIT_TASKS = (256, 1024, 4096)
# the counters against the plain versions: a budget where the plain
# descent's level loop (a host read a level) is affordable
METRICS_CHECK_PLAYOUTS = 8192

# the root-parallel forest path: 8 trees of 32 lanes (256 lanes a launch,
# the single tree's width), 128 tasks a member (grain 1024 on the first
# move, the single tree's), 131,072 playouts a member (the paper's budget
# over the ensemble); then the visit-sum move is played, the forest
# re-rooted, and two warm moves searched at 32,768 playouts a member
FOREST = dict(board_size=11, n_workers=32, n_tasks=128, tree_cap=1 << 18,
              scheduler="fifo", cp=1.0, vl_rounds=1)
FOREST_TREES = 8
FOREST_PLAYOUTS = (131_072, 32_768, 32_768)
# the forest's checks: 4 members at 8,192 playouts each
FOREST_CHECK = dict(n_trees=4, n_playouts=8192)
# Gomoku: free-style, the standard 15x15 board, one tree of 256 lanes,
# 65,536 playouts in 256 tasks, then a re-rooted warm second move
GOMOKU = dict(game="gomoku", board_size=15, n_workers=256, n_tasks=256,
              tree_cap=1 << 17, scheduler="fifo", cp=1.0, vl_rounds=1)
GOMOKU_PLAYOUTS = (65_536, 65_536)
GOMOKU_CHECK_PLAYOUTS = 8192

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
# check_flash's shapes (B, H, Hkv, S, d), each in float32 and bfloat16,
# causal or not: the prefill shape, GQA, MQA, head dims 32-128, sequence
# lengths off the tile size, S = 1024 (the tensor-core body's
# double-buffered loop turns 16 times), the tensor-core body at d = 128 and
# 96, and bf16 at d = 48, which goes to the CUDA-core body
FLASH_CASES = [
    (64, 9, 3, 128, 64), (2, 4, 2, 128, 64), (1, 8, 1, 128, 128),
    (2, 2, 2, 128, 80), (2, 4, 2, 129, 64), (3, 6, 2, 200, 64),
    (1, 2, 1, 1, 64), (2, 4, 4, 37, 32), (2, 9, 3, 1024, 64),
    (2, 8, 2, 200, 128), (1, 8, 2, 1024, 128), (2, 4, 2, 300, 96),
    (2, 2, 1, 77, 48)]
# check_rmsnorm's shapes (D, N), each in float32 and bfloat16 with a
# float32 and a bfloat16 weight, both orders: D = 576, 1024 and an odd D
# (element loads) at 64, 8192 and 7 rows; then the launcher's other
# branches: more rows than the grid holds (each warp strides over rows),
# and rows too long for the registers (the two-pass body: D = 2560 float32,
# D = 1025 with element loads, D = 4104 in either dtype)
RMSNORM_CASES = [(D, N) for D in (576, 1024, 577) for N in (64, 64 * 128, 7)
                 ] + [(576, 2 * 8192 + 7), (2560, 7), (1025, 7), (4104, 7)]
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


def time_ms(fn, iters: int = 200, warmup: int = 20, reps: int = 5) -> float:
    """Milliseconds per call: CUDA events around `iters` calls, the median
    of `reps` such runs (a host that shares its cores varies run to run;
    every kernel and its yardstick are timed the same way)."""
    import statistics
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / iters)
    return statistics.median(runs)


def time_pair_ms(fn_a, fn_b, iters: int = 200, warmup: int = 20,
                 pairs: int = 6) -> tuple[float, float]:
    """Milliseconds per call of `fn_a` and of `fn_b` (a kernel and its
    library yardstick): batches of `iters` calls timed by CUDA events, the
    two taken in turns (a b, b a, ...) for `pairs` pairs, the median of
    each, so a drift of the shared host falls on both alike."""
    import statistics
    import torch
    for fn in (fn_a, fn_b):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    runs = ([], [])
    for i in range(pairs):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            fn = (fn_a, fn_b)[j]
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            torch.cuda.synchronize()
            runs[j].append(start.elapsed_time(stop) / iters)
    return statistics.median(runs[0]), statistics.median(runs[1])


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
    ptxas = _build.ptxas_report()
    check(ptxas, "no ptxas report beside the built library")
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         compiled_now=_build.last_build_seconds is not None,
         sources=[os.path.relpath(s, HERE) for s in _build.sources()],
         flags=list(_build.NVCC_FLAGS))
    # nvcc -Xptxas -v, per kernel: registers a thread, static shared memory
    # (the flash and norm kernels' shared memory is dynamic: lm_kernels
    # gives it), stack frame and spill bytes
    for row in ptxas:
        emit("ptxas", **row)


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


# threefry2x32: 2 + 20 x 5 + 5 x 3 + 2 integer operations a block; uniform
# adds 4 (xor, shift, or, subtract); one UCT score is ~12 float operations
THREEFRY_OPS = 119
UNIFORM_OPS = THREEFRY_OPS + 4
UCT_OPS = 12


def grown_tree(torch, size, workers, playouts, cap, seed):
    """The tree of a real search on the card (the kernels' path)."""
    from repro_torch import rng
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    cfg = GSCPMConfig(board_size=size, n_workers=workers, n_tasks=workers * 4,
                      n_playouts=playouts, tree_cap=cap)
    board = cfg.game_obj.init_board("cuda")
    tree, _ = gscpm_search(board, 1, cfg, rng.key(seed, "cuda"))
    return tree, board


def partly_filled(torch, size, empties, seed):
    """A board of `size` with only `empties` empty cells, stones alternating
    over a seeded random order of the others."""
    n = size * size
    g = torch.Generator().manual_seed(seed)
    order = torch.randperm(n, generator=g)
    board = torch.zeros(n, dtype=torch.int8)
    stones = order[empties:]
    board[stones] = (1 + torch.arange(stones.numel()) % 2).to(torch.int8)
    return board.cuda()


def descent_cases(torch):
    """(name, tree, root board, game, lanes) for the descent check: trees of
    real searches (11x11 at the main path's 256 lanes, 7x7), the same with
    virtual loss on every node (the second round of vl_rounds = 2), trees
    whose siblings score alike so the noise decides every pick (sizes 2, 5
    and 11; at size 2 the depth cap stops the lanes, at 11 the filled
    board), and held lanes (a root one child short of fully expanded)."""
    from repro_torch import parity
    from repro_torch.core.hex import HexGame
    cases = []
    t11, b11 = grown_tree(torch, 11, 256, SHORT_PLAYOUTS, 1 << 18, seed=3)
    t7, b7 = grown_tree(torch, 7, 16, 8192, 1 << 14, seed=4)
    for size, t, b, W in ((11, t11, b11, 256), (7, t7, b7, 16)):
        name = f"search {size}x{size}"
        cases.append((name, t, b, HexGame(size), W))
        v = parity.clone_tree(t)
        g = torch.Generator(device="cuda").manual_seed(W)
        v.vloss.copy_(torch.randint(0, 3, v.vloss.shape, generator=g,
                                    device="cuda").float())
        v.vloss[v.cap] = 0.0
        cases.append((name + ", virtual loss", v, b, HexGame(size), W))
    for size, empties, levels, W in ((11, 5, 5, 256), (5, 6, 3, 16),
                                     (2, 4, 4, 7)):
        b = partly_filled(torch, size, empties, seed=size)
        t = parity.equal_stat_tree(b, levels, 1, 1024, seed=size)
        cases.append((f"equal stats {size}x{size}", t, b, HexGame(size), W))
        held = parity.clone_tree(t)
        held.n_children[0] -= 1
        cases.append((f"held at the root {size}x{size}", held, b,
                      HexGame(size), W))
    cases += forest_descent_cases(torch, t11, b11)
    return cases, (t11, b11)


def forest_descent_cases(torch, t11, b11):
    """Forest cases for the descent check (the member axis): 8 members of
    32 lanes on the 11x11 trees of a real forest search (the forest path's
    shape); 3 members on 7x7 from three different positions (members at
    different depths) and the same with one member's root held; the 11x11
    single tree as a forest of one; three equal-stat 5x5 members of 1, 2
    and 3 levels with one member held at the root."""
    from repro_torch import parity, rng
    from repro_torch.core.gscpm import GSCPMConfig
    from repro_torch.core.hex import HexGame
    from repro_torch.core.root_parallel import gscpm_search_batch
    from repro_torch.core.tree import Tree
    cases = []
    cfg = GSCPMConfig(**{**FOREST, "n_playouts": 8192, "tree_cap": 1 << 16})
    board = cfg.game_obj.init_board("cuda")
    f11, _ = gscpm_search_batch(board, 1, cfg, rng.key(11, "cuda"),
                                n_trees=8)
    cases.append(("forest path shape: 11x11, E=8", f11,
                  board.expand(8, -1).contiguous(), cfg.game_obj,
                  cfg.n_workers))
    boards = torch.stack([partly_filled(torch, 7, e, seed=e)
                          for e in (49, 30, 12)])
    cfg7 = GSCPMConfig(board_size=7, n_workers=16, n_tasks=64,
                       n_playouts=2048, tree_cap=1 << 13)
    f7, _ = gscpm_search_batch(boards, torch.tensor([1, 1, 1]), cfg7,
                               rng.key(7, "cuda"))
    cases.append(("forest 7x7, E=3, three positions", f7, boards,
                  HexGame(7), 16))
    held = parity.clone_tree(f7)
    held.n_children[1, 0] -= 1
    cases.append(("forest 7x7, E=3, member 1 held at the root", held, boards,
                  HexGame(7), 16))
    size = math.isqrt(b11.numel())
    cases.append((f"forest of one, {size}x{size}",
                  Tree(*(t[None] for t in t11)), b11[None], HexGame(size),
                  256))
    eq_boards = torch.stack([partly_filled(torch, 5, 6, seed=s)
                             for s in (5, 6, 7)])
    members = [parity.equal_stat_tree(eq_boards[i], levels, 1, 1024, seed=i)
               for i, levels in enumerate((1, 2, 3))]
    eq = Tree(*(torch.stack(f) for f in zip(*members)))
    eq.n_children[2, 0] -= 1
    cases.append(("forest equal stats 5x5, E=3, depths 1-3, member 2 held",
                  eq, eq_boards, HexGame(5), 16))
    return cases


def check_select_descent(torch, cases):
    """The descent kernel against its plain version (the level loop with
    every dispatch plain) on every case, noise off and on, cp 1.0 and 0.35:
    all five outputs equal, except lanes that part at a pick inside the tie
    gap (0 < gap < TIE_GAP by the plain arithmetic), which are counted."""
    from repro_torch import parity, rng
    from repro_torch.kernels import ref, select_descent as sd
    from repro_torch.core.tree import forest_member
    lanes = excused = noise_decided = 0
    per_case = {}
    for ci, (name, tree, board, game, W) in enumerate(cases):
        # a forest's (E, cap + 1) fields take (E, W, 2) keys: one launch
        E = tree.parent.shape[0] if tree.parent.dim() == 2 else None
        keys = rng.split(rng.key(100 + ci, "cuda"), W * (E or 1))
        keys = keys if E is None else keys.view(E, W, 2)
        paths_no_noise = None
        for scale in (0.0, 1e-3):
            for cp in (1.0, 0.35):
                before = sd.select_descent.launches
                got = sd.select_descent(tree, board, keys, cp, scale,
                                        game.max_moves + 1)
                check(sd.select_descent.launches == before + 1,
                      f"select_descent ({name}): not one launch")
                want = ref.select_descent(tree, board, game, cp, keys, scale)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    check(a.dtype == b.dtype and a.shape == b.shape,
                          f"select_descent ({name}): output {a.dtype} "
                          f"{tuple(a.shape)} != plain {b.dtype} {tuple(b.shape)}")
                members = [(tree, got, want, keys)] if E is None else [
                    (forest_member(tree, e), [x[e] for x in got],
                     [x[e] for x in want], keys[e]) for e in range(E)]
                partings = [p for t, g, w, k in members
                            for p in parity.descent_partings(t, g, w, cp, k,
                                                             scale)]
                bad = [p for p in partings if not p["excused"]]
                check(not bad, f"select_descent ({name}, noise {scale}, cp "
                               f"{cp}): parts from the plain version: {bad[:3]}")
                excused += len(partings)
                lanes += W * (E or 1)
                flat_paths = got[0].reshape(-1, got[0].shape[-1])
                if cp == 1.0 and scale == 0.0:
                    paths_no_noise = flat_paths
                elif cp == 1.0:
                    noise_decided_here = int((flat_paths != paths_no_noise)
                                             .any(dim=1).sum())
                    per_case[name] = {
                        "lanes": W * (E or 1), "members": E or 1,
                        "mean_depth": float(got[1].float().mean()),
                        "max_depth": int(got[1].max()),
                        "lanes_the_noise_moved": noise_decided_here}
                    if "equal stats" in name:
                        noise_decided += noise_decided_here
    check(noise_decided > 0, "select_descent: the noise decided no pick on "
                             "the equal-stat trees")
    return {"lanes": lanes, "mismatches": 0, "excused_tie_gap": excused,
            "equal_stat_lanes_the_noise_moved": noise_decided,
            "cases": per_case, "max_abs_err": 0}


def playout_boards(torch, size):
    """Leaf boards for the playout check: 256 random boards whose share of
    empty cells runs from none to all, the adversarial filled boards, and
    the same with a third of their cells emptied."""
    n = size * size
    g = torch.Generator(device="cuda").manual_seed(1000 + size)
    stones = torch.randint(1, 3, (256, n), generator=g, device="cuda")
    share = torch.linspace(0, 1, 256, device="cuda")[:, None]
    empty = torch.rand((256, n), generator=g, device="cuda") < share
    rand = torch.where(empty, 0, stones).to(torch.int8)
    adv = adversarial_boards(torch, size)
    holes = torch.rand(adv.shape, generator=g, device="cuda") < 1 / 3
    return torch.cat([rand, adv, torch.where(holes, 0, adv).to(torch.int8)])


def check_hex_playout(torch):
    """The playout kernel against the plain fill + winner on the card:
    filled boards equal bit for bit (through the kernel's optional filled
    output), winners equal, also to the flood fill, and the search's call
    (no filled output) gives the same winners."""
    from repro_torch import rng
    from repro_torch.core import hex as hx
    from repro_torch.kernels import hex_playout as hp, ref
    boards_checked = 0
    for size in (2, 5, 7, 11, 13, 19):
        boards = playout_boards(torch, size)
        W = boards.shape[0]
        g = torch.Generator(device="cuda").manual_seed(size)
        to_move = torch.randint(1, 3, (W,), generator=g, device="cuda",
                                dtype=torch.int32)
        keys = rng.split(rng.key(size, "cuda"), W)
        got, filled = hp.hex_playout(boards, to_move, keys, size,
                                     with_filled=True)
        lean = hp.hex_playout(boards, to_move, keys, size)
        torch.cuda.synchronize()
        spec = hx.HexSpec(size)
        want_filled = hx.random_fill_batch(boards, to_move, keys, spec)
        want = ref.hex_winner(want_filled, size)
        check(got.dtype == torch.int8 and got.shape == (W,)
              and filled.dtype == torch.int8 and filled.shape == boards.shape,
              "hex_playout: wrong output type or shape")
        bad = int((filled != want_filled).any(dim=1).sum())
        check(bad == 0, f"hex_playout size {size}: {bad} filled boards differ "
                        "from the plain fill")
        check(torch.equal(got, want), f"hex_playout size {size}: winners "
                                      "differ from the plain version")
        check(torch.equal(lean, got), f"hex_playout size {size}: the call "
                                      "without filled output differs")
        check(torch.equal(want, hx.winner_flood_batch(want_filled, spec)),
              f"hex_playout size {size}: plain winner != flood fill")
        boards_checked += W
    return {"boards": boards_checked, "mismatches": 0, "max_abs_err": 0}


def descent_work(torch, tree, paths, depths, n_root_empty, n, max_depth):
    """(bytes, operations) one descent needs for these outputs: each tree
    entry read once (per scored node its counters and its children's ids and
    statistics, per path node its move), the root board and keys read once,
    the outputs written once; per lane and level a fold_in and, per child,
    a uniform and a score."""
    W = depths.shape[0]
    cols = torch.arange(paths.shape[1], device=paths.device)[None, :]
    scored = torch.unique(paths[cols < depths[:, None]])
    on_path = torch.unique(paths[(cols >= 1) & (cols <= depths[:, None])])
    kids = tree.n_children[scored].long()
    tree_bytes = int((16 + 16 * kids).sum()) + 4 * on_path.numel() + 4 * W
    out_bytes = W * (4 * max_depth + 12 + n)
    n_bytes = tree_bytes + n + 16 * W + out_bytes
    levels = depths.long()
    # children at level l of a lane: n_root_empty - l (a fully expanded node)
    slots = int((levels * n_root_empty - levels * (levels - 1) // 2).sum())
    n_ops = slots * (UNIFORM_OPS + UCT_OPS) + int(levels.sum()) * (
        THREEFRY_OPS + 10)
    return n_bytes, n_ops


def playout_work(torch, boards, rounds):
    """(bytes, operations) of W playouts: boards, movers and keys read
    once, winners written once; per board n uniforms, E x E rank
    comparisons among its E empty cells, and the labelling rounds."""
    W, n = boards.shape
    E = (boards == 0).sum(dim=1).long()
    n_bytes = W * n + 4 * W + 16 * W + W
    n_ops = W * n * UNIFORM_OPS + int((3 * E * E).sum()) + W * n * rounds * 20
    return n_bytes, n_ops


def phase_kernels(torch):
    """Hold the game-search kernels (the descent and the playout, the
    one-tile uct_select and hex_winner) against their plain versions on the
    card, then time them at the shapes the main path gives them."""
    from repro_torch.core import hex as hx
    from repro_torch.core.hex import doubling_rounds
    from repro_torch.kernels import hex_winner as hw, ref, uct_select as us

    uct = check_uct_select(torch)
    hexw = check_hex_winner(torch)
    cases, (t11, b11) = descent_cases(torch)
    descent = check_select_descent(torch, cases)
    playout = check_hex_playout(torch)

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

    # the descent at the main path's shape: 256 lanes on the 11x11 tree of
    # a 65,536-playout search, noise on, cp 1
    from repro_torch import rng
    from repro_torch.kernels import hex_playout as hp, select_descent as sd
    game = hx.HexGame(size)
    keys = rng.split(rng.key(7, "cuda"), W)
    descent_call = lambda: sd.select_descent(t11, b11, keys, 1.0, 1e-3,
                                             game.max_moves + 1)
    paths, depths = descent_call()[:2]
    sd_ms = time_ms(descent_call)
    sd_graph = graph_ms(descent_call)
    sd_plain = time_ms(lambda: ref.select_descent(t11, b11, game, 1.0, keys,
                                                  1e-3), iters=10, warmup=2)
    sd_bytes, sd_ops = descent_work(torch, t11, paths, depths, C, C,
                                    game.max_moves + 1)
    sd_bound, sd_by = bound_ms(sd_bytes, sd_ops, OPS_PER_S)
    # and at the forest path's shape: 8 members of 32 lanes, one launch
    _, f11, fb11, _, fW = next(c for c in cases
                               if c[0].startswith("forest path shape"))
    fkeys = rng.split(rng.key(8, "cuda"), 8 * fW).view(8, fW, 2)
    forest_call = lambda: sd.select_descent(f11, fb11, fkeys, 1.0, 1e-3,
                                            game.max_moves + 1)
    sd_forest_ms = time_ms(forest_call)
    sd_forest_graph = graph_ms(forest_call)

    # the playout at the main path's shape: 256 leaf boards a few stones
    # deep (the search's leaves lie 1-8 plies below the empty root)
    g = torch.Generator(device="cuda").manual_seed(8)
    stones = torch.randint(1, 3, (W, C), generator=g, device="cuda")
    deep = torch.rand((W, C), generator=g, device="cuda") < 4 / C
    leaves = torch.where(deep, stones, 0).to(torch.int8)
    movers = torch.randint(1, 3, (W,), generator=g, device="cuda",
                           dtype=torch.int32)
    po_keys = rng.split(rng.key(9, "cuda"), W)
    playout_call = lambda: hp.hex_playout(leaves, movers, po_keys, size)
    hp_ms = time_ms(playout_call)
    hp_graph = graph_ms(playout_call)
    hp_plain = time_ms(lambda: ref.hex_playout(leaves, movers, po_keys, size),
                       iters=10, warmup=2)
    hp_bytes, hp_ops = playout_work(torch, leaves, doubling_rounds(C))
    hp_bound, hp_by = bound_ms(hp_bytes, hp_ops, OPS_PER_S)

    records = [
        {"name": "select_descent", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/uct_select.cu",
         "replaces": "src/repro/kernels/uct_select.py:36",
         "shape": [W, C], "checked": descent, "max_abs_err": 0,
         "ms": sd_ms, "in_graph_ms": sd_graph, "plain_ms": sd_plain,
         "bound_ms": sd_bound, "bound_by": sd_by, "library_ms": None,
         "timed_on": {"tree": "11x11, 65,536-playout search",
                      "mean_lane_depth": float(depths.float().mean()),
                      "max_lane_depth": int(depths.max()),
                      "bytes": sd_bytes, "operations": sd_ops},
         "forest_ms": sd_forest_ms, "forest_in_graph_ms": sd_forest_graph,
         "forest_timed_on": "8 members x 32 lanes, 11x11, 8,192-playout "
                            "forest search"},
        {"name": "hex_playout", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hex_winner.cu",
         "replaces": "src/repro/kernels/hex_winner.py:46",
         "shape": [W, C], "checked": playout, "max_abs_err": 0,
         "ms": hp_ms, "in_graph_ms": hp_graph, "plain_ms": hp_plain,
         "bound_ms": hp_bound, "bound_by": hp_by, "library_ms": None,
         "timed_on": {"mean_empty_cells": float((leaves == 0).sum(dim=1)
                                                .float().mean()),
                      "bytes": hp_bytes, "operations": hp_ops}},
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
         select_descent=descent, hex_playout=playout,
         note="every bound is far below one launch's latency: at these "
              "shapes the kernels are launch-bound")
    return records


# ------------------------------------------------------------------ search ----
def count_launches_one_iteration(torch, tree, board, cfg, key, metrics=None):
    """CUDA kernel launches of ONE sync iteration on `tree` (which it
    advances), by torch.profiler; None if the profiler saw no device
    activity. A forest (with (E, n) boards) runs one iteration for all its
    members, with the member streams of ``gscpm_search_batch``. With a
    ``metrics`` accumulator the iteration updates it too."""
    from repro_torch import rng
    from repro_torch.core import gscpm, root_parallel
    from torch.profiler import ProfilerActivity, profile
    W = cfg.n_workers
    task_ids = torch.arange(10_000, 10_000 + W, dtype=torch.int32,
                            device="cuda")
    if tree.parent.dim() == 2:
        E = tree.parent.shape[0]
        member_keys = gscpm.fold_task_keys(
            key, torch.arange(E, dtype=torch.int32, device="cuda"))
        task_keys = root_parallel.fold_member_task_keys(member_keys, task_ids)
        active = torch.ones((E, W), dtype=torch.bool, device="cuda")
    else:
        task_keys = gscpm.fold_task_keys(key, task_ids)
        active = torch.ones(W, dtype=torch.bool, device="cuda")
    iter_keys = rng.fold_in(task_keys, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gscpm.sync_iteration(tree, board, cfg, cfg.cp, iter_keys, active,
                             metrics)
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


@contextlib.contextmanager
def recorded_depths():
    """Keep every selection round's `depths` output (the descent's own
    lane depths) while the context is open: host-side only, no launch and
    no read until the caller reduces them."""
    from repro_torch.kernels import ops
    seen, inner = [], ops.select_descent

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out[1])
        return out

    ops.select_descent = recording
    try:
        yield seen
    finally:
        ops.select_descent = inner


def depth_stats(torch, seen) -> dict:
    """Mean lane depth over every lane of every round, and the mean of
    (deepest lane + 1) per round: the trip count the plain version's
    lockstep level loop would make, one uct_select launch per level."""
    depths = torch.stack(seen)
    return {"mean_lane_depth": float(depths.float().mean()),
            "mean_lockstep_levels": float((depths.max(dim=1).values + 1)
                                          .float().mean()),
            "selection_rounds": depths.shape[0]}


def search_counters():
    from repro_torch.kernels import hex_playout as hp, hex_winner as hw
    from repro_torch.kernels import select_descent as sd, uct_select as us
    return {"select_descent": sd.select_descent, "hex_playout": hp.hex_playout,
            "uct_select": us.uct_select, "hex_winner": hw.hex_winner}


def sync_iterations(cfg) -> int:
    from repro_torch.core import scheduler as sched
    return sum(r.m for r in sched.make_schedule(
        cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler))


def phase_search(torch, n_playouts: int):
    from repro_torch import parity, rng
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    from repro_torch.core.tree import check_invariants

    cap = FULL["tree_cap"] if n_playouts <= SHORT_PLAYOUTS else 1 << 20
    cfg = GSCPMConfig(**{**FULL, "tree_cap": cap}, n_playouts=n_playouts)
    game = cfg.game_obj
    board = game.init_board("cuda")
    key = rng.key(0, "cuda")
    iterations = sync_iterations(cfg)

    # warm the allocator and every torch op on a short search first
    gscpm_search(board, 1, GSCPMConfig(**FULL, n_playouts=2048), key)

    # the same full-width search twice, at the cut-down budget: atomics add
    # only 0, 0.5 and 1, so the two trees must be bit-identical
    short = GSCPMConfig(**FULL, n_playouts=SHORT_PLAYOUTS)
    short_iters = sync_iterations(short)
    with recorded_depths() as seen:
        tree_a, st_a = gscpm_search(board, 1, short, key)
    short_depths = depth_stats(torch, seen)
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
         **short_depths, tree_nodes=st_a["tree_nodes"])
    del tree_a, tree_b

    # the main path: counts to 0 just before, read just after
    counters = search_counters()
    for c in counters.values():
        c.launches = 0
    with recorded_depths() as seen:
        tree, st = gscpm_search(board, 1, cfg, key)
    launches = {name: c.launches for name, c in counters.items()}
    depths = depth_stats(torch, seen)

    rounds = iterations * cfg.vl_rounds
    check(st["playouts"] == n_playouts, "playout count differs from the budget")
    check(float(tree.visits[0]) == n_playouts,
          f"root visits {float(tree.visits[0])} != playouts {n_playouts}")
    check_invariants(tree)
    check(launches["select_descent"] == rounds,
          f"select_descent launches {launches['select_descent']} != selection "
          f"rounds {rounds}")
    check(launches["hex_playout"] == iterations,
          f"hex_playout launches {launches['hex_playout']} != sync iterations "
          f"{iterations}")
    check(launches["uct_select"] == 0 and launches["hex_winner"] == 0,
          f"the one-tile kernels launched on the Hex path: {launches}")
    check(torch.isfinite(tree.wins).all() and torch.isfinite(tree.visits).all(),
          "non-finite tree statistics")
    check(0 <= st["best_move"] < game.n_cells, "best move off the board")

    n_kernels, dev_ms = count_launches_one_iteration(torch, tree, board, cfg,
                                                     key)
    check(n_kernels is not None and n_kernels <= MAX_KERNELS_PER_ITERATION,
          f"one sync iteration launched {n_kernels} CUDA kernels, more than "
          f"{MAX_KERNELS_PER_ITERATION}")
    rate = st["playouts_per_s"]
    emit("search", config={**FULL, "tree_cap": cap, "n_playouts": n_playouts},
         playouts_per_s=rate, seconds=st["time_s"],
         sync_iterations=iterations,
         ms_per_sync_iteration=1e3 * st["time_s"] / iterations,
         **depths, launches=launches, tree_nodes=st["tree_nodes"],
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
    the first sync iteration after which the trees differ, the selection
    round must part at a pick inside the tie gap (0 < gap < TIE_GAP).
    Anything else — a clear pick, or a difference outside the descent
    (the playout is integer-exact) — is a failure."""
    from repro_torch import parity
    from repro_torch.core import gscpm
    from repro_torch.core.tree import init_tree
    from repro_torch.kernels import ops
    a = init_tree(cfg.tree_cap, cfg.game_obj.n_actions, 1, device="cuda")
    b = parity.clone_tree(a)
    for it, (iter_keys, active) in enumerate(parity.iteration_plan(cfg, key)):
        before = parity.clone_tree(a)
        gscpm.sync_iteration(a, board, cfg, cfg.cp, iter_keys, active)
        with ops.plain_versions():
            gscpm.sync_iteration(b, board, cfg, cfg.cp, iter_keys, active)
        if parity.differing_fields(a, b):
            pick = parity.first_divergent_descent(before, board, cfg, cfg.cp,
                                                  iter_keys)
            check(pick is not None,
                  f"trees differ after sync iteration {it} but the "
                  "selection round agrees: the playout or the backup differs")
            check(pick["excused"],
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


# ------------------------------------------------------- paper experiments ----
def phase_paper_sweep(torch, seq_rate: float):
    """The paper's grain-size experiment at the card's width: 11x11 Hex, 256
    lanes, Cp = 1, 65,536 playouts a point, fifo and rebalance across
    nTasks and one task a lane; speedup over the sequential searcher's
    rate. Every point's tree holds its invariants and its root visits equal
    its playouts."""
    from repro_torch import rng
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    from repro_torch.core.tree import check_invariants

    board, key = torch.zeros(121, dtype=torch.int8, device="cuda"), rng.key(
        0, "cuda")
    plan = [(s, t) for s in ("fifo", "rebalance") for t in PAPER_SWEEP_TASKS]
    plan.append(("one_per_core", FULL["n_workers"]))
    counters = search_counters()
    for c in counters.values():
        c.launches = 0
    points, rounds, iterations = [], 0, 0
    for sched, n_tasks in plan:
        cfg = GSCPMConfig(**{**FULL, "n_tasks": n_tasks, "scheduler": sched},
                          n_playouts=SHORT_PLAYOUTS)
        tree, st = gscpm_search(board, 1, cfg, key)
        check_invariants(tree)
        check(float(tree.visits[0]) == st["playouts"],
              f"paper_sweep {sched} {n_tasks}: root visits "
              f"{float(tree.visits[0])} != playouts {st['playouts']}")
        n_iter = sync_iterations(cfg)
        rounds += n_iter * cfg.vl_rounds
        iterations += n_iter
        points.append({
            "scheduler": sched, "n_tasks": n_tasks, "grain": st["grain"],
            "rounds": st["rounds"], "sync_iterations": n_iter,
            "playouts": st["playouts"], "playouts_per_s": st["playouts_per_s"],
            "masked_lane_fraction": st["masked_lane_fraction"],
            "speedup": st["playouts_per_s"] / seq_rate,
            "tree_nodes": st["tree_nodes"], "best_move": st["best_move"]})
        del tree
    launches = {name: c.launches for name, c in counters.items()}
    check(launches["select_descent"] == rounds,
          f"paper_sweep: select_descent launches "
          f"{launches['select_descent']} != selection rounds {rounds}")
    check(launches["hex_playout"] == iterations,
          f"paper_sweep: hex_playout launches {launches['hex_playout']} != "
          f"sync iterations {iterations}")
    check(launches["uct_select"] == 0 and launches["hex_winner"] == 0,
          f"paper_sweep: the one-tile kernels launched: {launches}")
    emit("paper_sweep", config={**FULL, "n_playouts": SHORT_PLAYOUTS},
         sequential_playouts_per_s=seq_rate, points=points,
         launches=launches)
    return launches


def phase_search_metrics(torch):
    """The device counters: a search with metrics on is bit-identical to the
    same search with metrics off (single tree at 65,536 playouts, the 8 x
    32 forest at its check size); the counters are conserved against the
    tree, the schedule and the descent's own depths; with the kernels they
    equal the counters with the plain versions."""
    import dataclasses

    from repro_torch import parity, rng
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    from repro_torch.core.root_parallel import gscpm_search_batch
    from repro_torch.obsv import init_search_metrics

    board, key = torch.zeros(121, dtype=torch.int8, device="cuda"), rng.key(
        0, "cuda")
    off = GSCPMConfig(**FULL, n_playouts=SHORT_PLAYOUTS)
    on = dataclasses.replace(off, metrics=True)
    with recorded_depths() as seen:
        t_off, s_off = gscpm_search(board, 1, off, key)
    t_on, s_on = gscpm_search(board, 1, on, key)
    fields = parity.differing_fields(t_off, t_on)
    check(fields == [], f"metrics on vs off: the trees differ in {fields}")
    m = s_on["metrics"]
    depth_total = int(torch.stack(seen).sum())
    lanes = sum(x.numel() for x in seen)
    check(m["lane_playouts"] == s_on["playouts"] == lanes,
          f"lane_playouts {m['lane_playouts']} != playouts {s_on['playouts']}")
    check(m["expansions"] == s_on["tree_nodes"] - 1 - m["tree_nodes_reused"],
          f"expansions {m['expansions']} != tree nodes {s_on['tree_nodes']} "
          f"- 1 - reused {m['tree_nodes_reused']}")
    check(m["tree_nodes_peak"] == s_on["tree_nodes"], "tree_nodes_peak")
    check(m["depth_sum"] == depth_total,
          f"depth_sum {m['depth_sum']} != the descent's own depths "
          f"{depth_total}")
    check(m["sync_iterations"] == sync_iterations(off), "sync_iterations")
    check(m["expand_proposals"] == m["expansions"] + m["expand_collisions"],
          "proposals != expansions + collisions")
    n_on, dev_on = count_launches_one_iteration(
        torch, t_on, board, on, key, metrics=init_search_metrics())
    del t_off, t_on

    # the counters with the kernels == with the plain versions
    small = dataclasses.replace(on, n_playouts=METRICS_CHECK_PLAYOUTS)
    t_k, s_k = gscpm_search(board, 1, small, key)
    t_p, s_p = gscpm_search(board, 1, small, key, plain_kernels=True)
    parted = parity.differing_fields(t_k, t_p)
    explained = (explain_divergence(torch, dataclasses.replace(
        small, metrics=False), board, key) if parted else None)
    if not parted:
        check(s_k["metrics"] == s_p["metrics"],
              f"counters with the kernels {s_k['metrics']} != with the plain "
              f"versions {s_p['metrics']}")

    # the forest at its check size, on and off
    fcfg = GSCPMConfig(**{**FOREST, "tree_cap": 1 << 16},
                       n_playouts=FOREST_CHECK["n_playouts"])
    E = FOREST_TREES
    f_off, fs_off = gscpm_search_batch(board, 1, fcfg, key, n_trees=E)
    f_on, fs_on = gscpm_search_batch(
        board, 1, dataclasses.replace(fcfg, metrics=True), key, n_trees=E)
    fields = parity.differing_fields(f_off, f_on)
    check(fields == [], f"forest metrics on vs off: the forests differ in "
                        f"{fields}")
    fm = fs_on["metrics"]
    check(fm["lane_playouts"] == fs_on["playouts"], "forest lane_playouts")
    check(fm["expansions"] == sum(fs_on["tree_nodes"]) - E,
          "forest expansions != nodes - one root a member")
    check(fm["tree_nodes_peak"] == max(fs_on["tree_nodes"]),
          "forest tree_nodes_peak")
    emit("search_metrics",
         config={**FULL, "n_playouts": SHORT_PLAYOUTS},
         bit_identical=True, metrics=m,
         mean_lane_depth_from_descent=depth_total / lanes,
         cuda_kernels_in_one_iteration_metrics_on=n_on,
         device_ms_in_one_iteration_metrics_on=dev_on,
         kernel_vs_plain={"playouts": METRICS_CHECK_PLAYOUTS,
                          "trees_equal": not parted,
                          "counters_equal": not parted,
                          "first_divergent_pick": explained},
         forest={"config": {**FOREST, "tree_cap": 1 << 16, "n_trees": E,
                            "n_playouts": FOREST_CHECK["n_playouts"]},
                 "bit_identical": True, "metrics": fm})


def phase_trace_fit(torch):
    """Traced fifo searches at three grains: every round one span with the
    device synchronised inside it; the least-squares fit of the card's
    per-round dispatch cost and per-iteration cost must be identifiable,
    and no kernel build may stall a span (the library is loaded by now)."""
    from repro_torch import rng
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    from repro_torch.obsv import TraceRecorder, validate_trace
    from repro_torch.obsv.profile import fit_dispatch_profile

    board, key = torch.zeros(121, dtype=torch.int8, device="cuda"), rng.key(
        0, "cuda")
    tracer = TraceRecorder(process_name="chip-smoke-trace-fit")
    tracer.watch_compiles("kernels")
    for n_tasks in TRACE_FIT_TASKS:
        gscpm_search(board, 1, GSCPMConfig(**{**FULL, "n_tasks": n_tasks},
                                           n_playouts=SHORT_PLAYOUTS),
                     key, tracer=tracer)
    n_events = validate_trace(tracer.to_dict())
    builds = [e for e in tracer.events if e["name"] == "jit_compile"]
    check(not builds, f"a kernel build stalled a traced span: {builds}")
    prof = fit_dispatch_profile(tracer, n_workers=FULL["n_workers"])
    check(prof["identifiable"], f"the dispatch fit is not identifiable: {prof}")
    check(prof["n_excluded_compile"] == 0, "a span was excluded for a build")
    emit("trace_fit", config={**FULL, "n_playouts": SHORT_PLAYOUTS,
                              "n_tasks": list(TRACE_FIT_TASKS)},
         trace_events=n_events, **prof)


# ------------------------------------------------------------ hex forest ----
def paired_iteration_ms(torch, forest, boards, fcfg, tree, board, tcfg,
                        iters: int = 50, turns: int = 4) -> dict:
    """Milliseconds per sync iteration (host clock, synchronised) of the
    forest and of one single tree with as many lanes, in turns (forest,
    tree, tree, forest, ...) on the same card: the forest's own cost per
    iteration, apart from the host's drift between phases."""
    from repro_torch import rng
    from repro_torch.core import gscpm
    E, W = forest.parent.shape[0], fcfg.n_workers
    fkeys = rng.split(rng.key(3, "cuda"), E * W).view(E, W, 2)
    tkeys = fkeys.view(E * W, 2)
    f_act = torch.ones((E, W), dtype=torch.bool, device="cuda")
    t_act = f_act.view(-1)
    runs = {"forest": [], "single_tree": []}
    for turn in range(turns):
        for name in (("forest", "single_tree") if turn % 2 == 0
                     else ("single_tree", "forest")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                if name == "forest":
                    gscpm.sync_iteration(forest, boards, fcfg, fcfg.cp,
                                         rng.fold_in(fkeys, i), f_act)
                else:
                    gscpm.sync_iteration(tree, board, tcfg, tcfg.cp,
                                         rng.fold_in(tkeys, i), t_act)
            torch.cuda.synchronize()
            runs[name].append(1e3 * (time.perf_counter() - t0) / iters)
    return runs


def phase_hex_forest(torch):
    """The root-parallel forest path at full width: 8 trees of 32 lanes,
    three self-play moves (131,072 playouts a member, then the visit-sum
    move played, the forest re-rooted and two warm moves of 32,768), each
    sync iteration one pass for all members."""
    from repro_torch import parity, rng
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    from repro_torch.core.root_parallel import (check_forest_invariants,
                                                gscpm_search_batch)
    from repro_torch.core.tree import (check_reroot_retention, forest_member,
                                       reroot_forest)

    torch.cuda.reset_peak_memory_stats()
    E = FOREST_TREES
    cfgs = [GSCPMConfig(**FOREST, n_playouts=p) for p in FOREST_PLAYOUTS]
    game = cfgs[0].game_obj
    key = rng.key(0, "cuda")
    iters = [sync_iterations(c) for c in cfgs]
    # warm the allocator and every op on a short forest search first
    gscpm_search_batch(game.init_board("cuda"), 1,
                       GSCPMConfig(**{**FOREST, "tree_cap": 1 << 12},
                                   n_playouts=1024), key, n_trees=E)

    # the main path: counts to 0 just before, read just after
    counters = search_counters()
    for c in counters.values():
        c.launches = 0
    board, to_move, carry = game.init_board("cuda"), 1, None
    moves, retained = [], []
    with recorded_depths() as seen:
        for mvno, cfg in enumerate(cfgs):
            root_before = (carry.visits[:, 0].clone() if carry is not None
                           else torch.zeros(E, device="cuda"))
            forest, st = gscpm_search_batch(board, to_move, cfg,
                                            rng.fold_in(key, mvno),
                                            n_trees=E, forest=carry)
            mv = st["best_move_sum"]
            check(st["playouts"] == E * cfg.n_playouts,
                  f"forest move {mvno}: playout count differs from the budget")
            check(torch.equal(forest.visits[:, 0] - root_before,
                              torch.full((E,), float(cfg.n_playouts),
                                         device="cuda")),
                  f"forest move {mvno}: a member's root gained other than "
                  f"its {cfg.n_playouts} playouts")
            check(0 <= mv < game.n_cells, "forest: best move off the board")
            moves.append({
                "move": mvno, "playouts": st["playouts"],
                "playouts_per_s": st["playouts_per_s"],
                "seconds": st["time_s"], "sync_iterations": iters[mvno],
                "ms_per_sync_iteration": 1e3 * st["time_s"] / iters[mvno],
                "reused_nodes": st.get("reused_nodes", 0),
                "tree_nodes": st["tree_nodes"],
                "member_best_moves": st["member_best_moves"],
                "best_move_sum": mv, "best_move_vote": st["best_move_vote"]})
            if mvno == len(cfgs) - 1:
                break
            carry = reroot_forest(forest, mv)
            retained.append([check_reroot_retention(
                forest_member(forest, e), forest_member(carry, e), mv)
                for e in range(E)])
            moves[-1]["retained_nodes_per_member"] = retained[-1]
            board = game.place(board, torch.tensor(mv, device="cuda"),
                               to_move)
            to_move = 3 - to_move
    launches = {name: c.launches for name, c in counters.items()}
    depths = depth_stats(torch, seen)

    rounds = sum(iters) * FOREST["vl_rounds"]
    check(launches["select_descent"] == rounds,
          f"forest: select_descent launches {launches['select_descent']} != "
          f"selection rounds {rounds} (one launch a round for all members)")
    check(launches["hex_playout"] == sum(iters),
          f"forest: hex_playout launches {launches['hex_playout']} != sync "
          f"iterations {sum(iters)}")
    check(launches["uct_select"] == 0 and launches["hex_winner"] == 0,
          f"forest: the one-tile kernels launched: {launches}")
    check(torch.isfinite(forest.wins).all() and torch.isfinite(forest.visits).all(),
          "forest: non-finite tree statistics")
    check_forest_invariants(forest)
    boards = board.expand(E, -1).contiguous()
    n_kernels, dev_ms = count_launches_one_iteration(torch, forest, boards,
                                                     cfgs[-1], key)
    check(n_kernels is not None and n_kernels <= MAX_KERNELS_PER_ITERATION,
          f"one forest sync iteration launched {n_kernels} CUDA kernels, more "
          f"than {MAX_KERNELS_PER_ITERATION}")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    total_playouts = sum(m["playouts"] for m in moves)
    total_s = sum(m["seconds"] for m in moves)
    # the forest's iteration against the single tree's at the same 256
    # lanes, in turns (a single tree cloned from member 0)
    paired = paired_iteration_ms(
        torch, forest, boards, cfgs[-1],
        parity.clone_tree(forest_member(forest, 0)), board,
        GSCPMConfig(**FULL, n_playouts=FOREST_PLAYOUTS[-1]))
    del forest, carry

    # checks at a smaller budget: members == single trees with their member
    # keys, kernels == plain versions, the same forest twice bit-identical
    n_check = FOREST_CHECK["n_trees"]
    ccfg = GSCPMConfig(**{**FOREST, "tree_cap": 1 << 16},
                       n_playouts=FOREST_CHECK["n_playouts"])
    b0, k1 = game.init_board("cuda"), rng.key(1, "cuda")
    fa, _ = gscpm_search_batch(b0, 1, ccfg, k1, n_trees=n_check)
    fb, _ = gscpm_search_batch(b0, 1, ccfg, k1, n_trees=n_check)
    fields = parity.differing_fields(fa, fb)
    check(fields == [], f"the same forest run twice differs: {fields}")
    for e in range(n_check):
        t, _ = gscpm_search(b0, 1, ccfg, rng.fold_in(k1, e))
        fields = parity.differing_fields(forest_member(fa, e), t)
        check(fields == [], f"forest member {e} != gscpm_search with its "
                            f"member key: {fields}")
    fp, _ = gscpm_search_batch(b0, 1, ccfg, k1, n_trees=n_check,
                               plain_kernels=True)
    parted = [e for e in range(n_check) if parity.differing_fields(
        forest_member(fa, e), forest_member(fp, e))]
    explained = (explain_divergence(torch, ccfg, b0, rng.fold_in(k1, parted[0]))
                 if parted else None)
    emit("hex_forest", config={**FOREST, "n_trees": E,
                               "playouts_per_member": list(FOREST_PLAYOUTS)},
         moves=moves, playouts_per_s=total_playouts / total_s,
         seconds=total_s, sync_iterations=sum(iters), **depths,
         launches=launches, cuda_kernels_in_one_iteration=n_kernels,
         device_ms_in_one_iteration=dev_ms, peak_memory_mb=peak_mb,
         ms_per_sync_iteration_in_turns=paired,
         checks={"config": {**FOREST, "tree_cap": 1 << 16, **FOREST_CHECK},
                 "bit_identical_twice": True,
                 "members_equal_single_tree_searches": True,
                 "kernel_vs_plain_trees_equal": not parted,
                 "members_parted": parted,
                 "first_divergent_pick": explained})
    return launches, total_playouts / total_s


# ---------------------------------------------------------------- gomoku ----
def won_position_descent(torch, key):
    """Won Gomoku positions stop the descent: they have empty cells but no
    legal move, so no children. On the 15x15 board black (to move) has an
    open four in the middle row, white a stone in each corner; after a
    search the root's two winning children are such positions. Two cases,
    each held against the plain version: the root's other children
    weighed down with virtual loss and cp = 0, so every lane steps into a
    winning child and must stop there (depth 1, empties left); and the tree
    re-rooted at a winning move, where every lane stops at the root."""
    from repro_torch import parity, rng
    from repro_torch.core import gomoku as gm
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    from repro_torch.core.tree import reroot_tree
    from repro_torch.kernels import ref, select_descent as sd
    cfg = GSCPMConfig(**GOMOKU, n_playouts=GOMOKU_CHECK_PLAYOUTS)
    game, size = cfg.game_obj, cfg.board_size
    n, mid = size * size, size // 2
    board = torch.zeros(n, dtype=torch.int8, device="cuda")
    board[mid * size + mid - 2: mid * size + mid + 2] = 1
    board[torch.tensor([0, size - 1, n - size, n - 1], device="cuda")] = 2
    tree, _ = gscpm_search(board, 1, cfg, key)
    kids = tree.children[0, : int(tree.n_children[0])]
    wins_at = torch.tensor([mid * size + mid - 3, mid * size + mid + 2],
                           device="cuda")
    won_kids = kids[torch.isin(tree.move[kids], wins_at)]
    check(won_kids.numel() == 2, "gomoku won position: the root lacks a "
                                 "winning child")
    steered = parity.clone_tree(tree)
    steered.vloss[kids] = 1e6
    steered.vloss[won_kids] = 0.0
    W = cfg.n_workers
    keys = rng.split(rng.key(77, "cuda"), W)
    out = {}
    for name, t, b, cp, depth in (
            ("into a winning child", steered, board, 0.0, 1),
            ("re-rooted at a winning move", reroot_tree(tree, int(
                tree.move[won_kids[0]])), game.place(
                board, tree.move[won_kids[0]], 1), 1.0, 0)):
        got = sd.select_descent(t, b, keys, cp, 1e-3, n + 1)
        want = ref.select_descent(t, b, game, cp, keys, 1e-3)
        bad = [p for p in parity.descent_partings(t, got, want, cp, keys,
                                                  1e-3) if not p["excused"]]
        check(not bad, f"gomoku won position ({name}): the descent parts "
                       f"from its plain version: {bad[:3]}")
        _, depths, leaves, boards, n_empty = got
        check(bool((depths == depth).all()) and bool((n_empty > 0).all())
              and bool((t.n_children[leaves] == 0).all())
              and bool(gm.has_five_batch(boards, 1, gm.GomokuSpec(size)).all()),
              f"gomoku won position ({name}): a lane did not stop at the won "
              "position")
        out[name] = {"lanes": W, "depth": depth,
                     "leaves": sorted(set(leaves.tolist())),
                     "empty_cells_left": int(n_empty[0])}
    return out


def phase_gomoku(torch):
    """Gomoku on the standard 15x15 board: one 65,536-playout search of 256
    lanes, the tree re-rooted at the played move and a warm second move;
    its descent through select_descent at 225 children a node, its playout
    the PyTorch completion-time body on the card."""
    from repro_torch import parity, rng
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    from repro_torch.core.tree import (check_invariants,
                                       check_reroot_retention, reroot_tree)

    torch.cuda.reset_peak_memory_stats()
    cfgs = [GSCPMConfig(**GOMOKU, n_playouts=p) for p in GOMOKU_PLAYOUTS]
    game = cfgs[0].game_obj
    key = rng.key(0, "cuda")
    iters = [sync_iterations(c) for c in cfgs]
    gscpm_search(game.init_board("cuda"), 1,
                 GSCPMConfig(**{**GOMOKU, "tree_cap": 1 << 12},
                             n_playouts=1024), key)

    counters = search_counters()
    for c in counters.values():
        c.launches = 0
    board, to_move, carry = game.init_board("cuda"), 1, None
    moves = []
    with recorded_depths() as seen:
        for mvno, cfg in enumerate(cfgs):
            tree, st = gscpm_search(board, to_move, cfg,
                                    rng.fold_in(key, mvno), tree=carry)
            mv = st["best_move"]
            check(0 <= mv < game.n_cells, "gomoku: best move off the board")
            moves.append({
                "move": mvno, "playouts": st["playouts"],
                "playouts_per_s": st["playouts_per_s"],
                "seconds": st["time_s"], "sync_iterations": iters[mvno],
                "ms_per_sync_iteration": 1e3 * st["time_s"] / iters[mvno],
                "reused_nodes": st.get("reused_nodes", 0),
                "reused_visits": st.get("reused_visits", 0.0),
                "tree_nodes": st["tree_nodes"], "best_move": mv,
                "root_value": st["root_value"]})
            if mvno == len(cfgs) - 1:
                break
            carry = reroot_tree(tree, mv)
            moves[-1]["retained_nodes"] = check_reroot_retention(tree, carry,
                                                                 mv)
            board = game.place(board, torch.tensor(mv, device="cuda"),
                               to_move)
            to_move = 3 - to_move
    launches = {name: c.launches for name, c in counters.items()}
    depths = depth_stats(torch, seen)
    rounds = sum(iters) * GOMOKU["vl_rounds"]
    check(launches["select_descent"] == rounds,
          f"gomoku: select_descent launches {launches['select_descent']} != "
          f"selection rounds {rounds}")
    check(launches["hex_playout"] == 0 and launches["uct_select"] == 0
          and launches["hex_winner"] == 0,
          f"gomoku: a Hex or one-tile kernel launched: {launches}")
    check_invariants(tree)
    check(float(tree.visits[0]) == moves[-1]["reused_visits"]
          + GOMOKU_PLAYOUTS[-1], "gomoku: root visits != retained + playouts")
    n_kernels, dev_ms = count_launches_one_iteration(torch, tree, board,
                                                     cfgs[-1], key)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    del tree, carry

    ccfg = GSCPMConfig(**GOMOKU, n_playouts=GOMOKU_CHECK_PLAYOUTS)
    b0, k5 = game.init_board("cuda"), rng.key(5, "cuda")
    t_kernel, _ = gscpm_search(b0, 1, ccfg, k5)
    t_plain, _ = gscpm_search(b0, 1, ccfg, k5, plain_kernels=True)
    fields = parity.differing_fields(t_kernel, t_plain)
    explained = explain_divergence(torch, ccfg, b0, k5) if fields else None
    won = won_position_descent(torch, rng.key(6, "cuda"))
    total_playouts = sum(m["playouts"] for m in moves)
    total_s = sum(m["seconds"] for m in moves)
    emit("gomoku", config={**GOMOKU, "playouts": list(GOMOKU_PLAYOUTS)},
         moves=moves, playouts_per_s=total_playouts / total_s,
         seconds=total_s, sync_iterations=sum(iters), **depths,
         launches=launches, cuda_kernels_in_one_iteration=n_kernels,
         device_ms_in_one_iteration=dev_ms, peak_memory_mb=peak_mb,
         kernel_vs_plain={"playouts": GOMOKU_CHECK_PLAYOUTS,
                          "trees_equal": not fields,
                          "differing_fields": fields,
                          "first_divergent_pick": explained},
         won_position=won)
    return launches, total_playouts / total_s


# -------------------------------------------------------------- LM kernels ----
def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    """(bound in ms, what bounds it) for `n_bytes` moved and `n_ops` done."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def check_flash(torch):
    """Both flash bodies against the plain version on the card, at every
    shape of FLASH_CASES, causal or not, float32 and bfloat16, and in the
    model's strided (B, S, H, d) layout through ops; each call must run on
    the body ``body_for`` names."""
    from repro_torch.kernels import flash_attention as fa, ops, ref
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_by_body = dict.fromkeys(fa.BODIES, 0.0)
    cases_by_body = dict.fromkeys(fa.BODIES, 0)
    n = 0
    for i, (B, H, Hkv, S, d) in enumerate(FLASH_CASES):
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                g = torch.Generator(device="cuda").manual_seed(i)
                r = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dt)
                q, k, v = r(B, H, S, d), r(B, Hkv, S, d), r(B, Hkv, S, d)
                body = fa.body_for(dt, d)
                before = dict(fa.flash_attention.launches_by_body)
                got = fa.flash_attention(q, k, v, causal=causal)
                ran = {b: fa.flash_attention.launches_by_body[b] - before[b]
                       for b in fa.BODIES}
                check(ran == {b: int(b == body) for b in fa.BODIES},
                      f"flash_attention {(B, H, Hkv, S, d)} {dt}: ran {ran}, "
                      f"expected the {body} body")
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
                worst_by_body[body] = max(worst_by_body[body], err)
                cases_by_body[body] += 1
                n += 1
    return {"cases": n, "tolerance": FLASH_TOL, "max_abs_err": worst,
            "cases_by_body": cases_by_body,
            "max_abs_err_by_body": worst_by_body}


def bf16_steps(torch, a, b):
    """Per element, how many bfloat16 steps apart ``a`` and ``b`` lie."""
    def ordinal(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordinal(a) - ordinal(b)).abs()


def check_rmsnorm(torch):
    """The rmsnorm kernel against its plain version on the card at every
    shape of RMSNORM_CASES, both rounding orders, float32 and bfloat16 (see
    RMSNORM_* for the limits)."""
    from repro_torch.kernels import ref, rmsnorm as rn
    worst = {"float32": 0.0, "bfloat16": 0.0}
    share = steps = 0.0
    share_case = None
    other_share = 1.0
    n = 0
    for D, N in RMSNORM_CASES:
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
                    if s > share:
                        share, share_case = s, case
                    steps = max(steps, int(apart.max()))
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
            "bfloat16_share_differing_max_case": share_case,
            "bfloat16_steps_max": steps,
            "other_order_share_differing_min": other_share}


def host_us(torch, fn, calls: int = 2000) -> float:
    """Host microseconds per call of `fn`: `calls` calls on the host clock,
    the device synchronised before and after (what the host spends to
    launch one call, when the device keeps up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def phase_lm_kernels(torch):
    """Hold the two LM kernels against their plain versions on the card,
    then time them at the shapes the LM path gives them: flash attention at
    the prefill (64 lanes, 9 heads over 3 KV heads, 128 tokens, d=64, bf16,
    the model's strided layout: the tensor-core body; the CUDA-core body on
    the same shape in float32, for the record), rmsnorm at the decode step
    (64 x 576 bf16, the model's rounding order) and at the prefill (8192 x
    576). Each library yardstick is timed eagerly, in turns with its kernel
    (``time_pair_ms``), and in a CUDA graph, so host is compared with host
    and device with device."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build, flash_attention as fa, ops, ref
    flash = check_flash(torch)
    norm = check_rmsnorm(torch)

    B, H, Hkv, S, d = LM_PREFILL_SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    q = torch.randn(B, S, H, d, generator=g, device="cuda").to(bf)
    k = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(bf)
    v = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(bf)
    check(fa.body_for(q.dtype, d) == "tensor_cores",
          "the prefill's attention is not routed to the tensor-core body")
    fa_call = lambda: ops.flash_attention(q, k, v, causal=True)
    fa_graph = graph_ms(fa_call)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    fa_plain = time_ms(lambda: ref.flash_attention(qh, kh, vh, causal=True),
                       iters=20, warmup=3)
    qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
    lib_call = lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True)
    lib_strided = lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True)
    fa_ms, fa_lib = time_pair_ms(fa_call, lib_call)
    fa_lib_graph = graph_ms(lib_call)
    fa_lib_s, fa_lib_s_graph = time_ms(lib_strided), graph_ms(lib_strided)
    fa_lib_err = float((lib_call().transpose(1, 2).float()
                        - fa_call().float()).abs().max())
    # each input read once, the output written once; the causal pairs only
    fa_bytes = 2 * (2 * B * H * S * d + 2 * B * Hkv * S * d)
    fa_ops = 4 * B * H * (S * (S + 1) // 2) * d
    fa_bound, fa_by = bound_ms(fa_bytes, fa_ops, BF16_TENSOR_OPS_PER_S)
    # the CUDA-core body on the same shape in float32 (for the record: the
    # LM path runs bf16)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_call = lambda: ops.flash_attention(q32, k32, v32, causal=True)
    f32_bound, f32_by = bound_ms(2 * fa_bytes, fa_ops, OPS_PER_S)
    cuda_cores = {"dtype": "float32", "ms": time_ms(f32_call, iters=50),
                  "in_graph_ms": graph_ms(f32_call, launches=10),
                  "bound_ms": f32_bound, "bound_by": f32_by}
    lib = _build.load()
    blocks_per_sm = lib.repro_flash_attention_tc_blocks_per_sm(d)
    tensor_cores = {
        "dtype": "bfloat16", "ms": fa_ms, "in_graph_ms": fa_graph,
        "bound_ms": fa_bound, "bound_by": fa_by,
        "achieved_bytes_per_s": fa_bytes / (fa_graph * 1e-3),
        "dynamic_smem_bytes": lib.repro_flash_attention_tc_smem_bytes(d),
        "ctas_per_sm": blocks_per_sm}

    N, D = LM_DECODE_NORM_SHAPE
    x = torch.randn(N, 1, D, generator=g, device="cuda").to(bf)
    w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(bf)
    rn_call = lambda: ops.rmsnorm(x, w, 1e-5, order="model")
    rn_lib_call = lambda: F.rms_norm(x, (D,), w, 1e-5)
    rn_ms, rn_lib = time_pair_ms(rn_call, rn_lib_call)
    rn_graph, rn_lib_graph = graph_ms(rn_call), graph_ms(rn_lib_call)
    rn_plain = time_ms(lambda: ref.rmsnorm(x, w, 1e-5, order="model"))
    rn_bytes = 2 * (2 * N * D + D)
    rn_ops = 4 * N * D            # square, add, scale, weight per element
    rn_bound, rn_by = bound_ms(rn_bytes, rn_ops, OPS_PER_S)
    # the wrapper's host path, piece by piece (host clock, microseconds)
    rn_host = {"wrapper": host_us(torch, rn_call),
               "library": host_us(torch, rn_lib_call),
               "empty_like": host_us(torch, lambda: torch.empty_like(x)),
               "stream_on": host_us(torch,
                                    lambda: _build.stream_on(x.get_device()))}
    # the prefill's norm shape
    xp = torch.randn(B, S, D, generator=g, device="cuda").to(bf)
    rn_prefill_graph = graph_ms(lambda: ops.rmsnorm(xp, w, 1e-5,
                                                    order="model"))
    rn_prefill_lib_graph = graph_ms(lambda: F.rms_norm(xp, (D,), w, 1e-5))
    rn_prefill_bound, _ = bound_ms(2 * (2 * B * S * D + D), 4 * B * S * D,
                                   OPS_PER_S)

    records = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:38",
         "shape": [B, H, Hkv, S, d], "dtype": "bfloat16", "layout": "bshd",
         "body": "tensor_cores",
         "checked": flash, "max_abs_err": flash["max_abs_err"]["bfloat16"],
         "ms": fa_ms, "in_graph_ms": fa_graph, "plain_ms": fa_plain,
         "bound_ms": fa_bound, "bound_by": fa_by, "library_ms": fa_lib,
         "library_in_graph_ms": fa_lib_graph,
         "library_strided_ms": fa_lib_s,
         "library_strided_in_graph_ms": fa_lib_s_graph,
         "library_call": "torch.nn.functional.scaled_dot_product_attention"
                         "(is_causal=True, enable_gqa=True), on contiguous "
                         "(B, H, S, d) copies and on the strided bshd views",
         "library_max_abs_diff": fa_lib_err,
         "bodies": {"tensor_cores": tensor_cores, "cuda_cores": cuda_cores}},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:19",
         "shape": [N, 1, D], "dtype": "bfloat16", "order": "model",
         "checked": norm, "max_abs_err": norm["max_abs_err"]["bfloat16"],
         "ms": rn_ms, "in_graph_ms": rn_graph, "plain_ms": rn_plain,
         "bound_ms": rn_bound, "bound_by": rn_by, "library_ms": rn_lib,
         "library_in_graph_ms": rn_lib_graph,
         "library_call": "torch.nn.functional.rms_norm",
         "host_us": rn_host,
         "prefill_shape": [B, S, D], "prefill_in_graph_ms": rn_prefill_graph,
         "prefill_bound_ms": rn_prefill_bound,
         "prefill_library_in_graph_ms": rn_prefill_lib_graph},
    ]
    emit("lm_kernels", flash_attention=flash, rmsnorm=norm,
         timed={r["name"]: {k: r[k] for k in (
             "ms", "in_graph_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "library_in_graph_ms")}
                for r in records},
         flash_bodies=records[0]["bodies"], rmsnorm_host_us=rn_host,
         rmsnorm_prefill={k: records[1][k] for k in (
             "prefill_shape", "prefill_in_graph_ms", "prefill_bound_ms",
             "prefill_library_in_graph_ms")})
    return records


# --------------------------------------------------------------- LM search ----
def lm_path_counters():
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    from repro_torch.kernels import uct_select as us
    return {"flash_attention": fa.flash_attention, "rmsnorm": rn.rmsnorm,
            "uct_select": us.uct_select}


def profile_prefill(torch, params, mcfg, tokens, max_len):
    """One prefill of `tokens` (W, P): its host wall time (ms, ending in a
    device synchronise), then, by torch.profiler on a second prefill, the
    CUDA kernels it launches, their device-busy ms and the flash kernels'
    share of it. Fails if the profiler saw no device activity."""
    from repro_torch.models import api
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = lambda: api.prefill(params, mcfg, {"tokens": tokens}, max_len)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels, device_us, flash_us = 0, 0.0, 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not ev.name.startswith(
                ("Memcpy", "Memset")):
            kernels += 1
            us = float(getattr(ev, "device_time", 0.0) or 0.0)
            device_us += us
            if "flash" in ev.name:
                flash_us += us
    check(kernels > 0, "torch.profiler saw no CUDA kernel in a prefill")
    return {"wall_ms": wall_ms, "cuda_kernels": kernels,
            "device_ms": device_us / 1e3, "flash_device_ms": flash_us / 1e3}


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

    from repro_torch.kernels import flash_attention as fa
    counters = lm_path_counters()
    for c in counters.values():
        c.launches = 0   # the LM path's counts: zeroed just before
    fa.flash_attention.launches_by_body = dict.fromkeys(fa.BODIES, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks_a, st_a = mcts_generate(params, mcfg, prompt, n_tokens, dcfg, key,
                                 keep_trees=True)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    flash_by_body = dict(fa.flash_attention.launches_by_body)
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
    check(flash_by_body == {"tensor_cores": n_tokens * L, "cuda_cores": 0},
          f"flash_attention launches by body {flash_by_body}: the bf16 "
          "prefill must run on the tensor-core body only")
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
    prefill = profile_prefill(torch, params, mcfg,
                              prompt[None, :].repeat(W, 1), max_len)

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
         prefill_profiled=prefill,
         sync_iterations=iters,
         ms_per_sync_iteration=1e3 * search_s / iters,
         ms_per_decode_step=decode_ms,
         playouts_per_s=n_tokens * n_playouts / search_s,
         tokens_per_s=n_tokens / wall_a,
         tree_nodes=[s["tree_nodes"] for s in st_a],
         launches=launches, flash_attention_launches_by_body=flash_by_body,
         mean_descent_levels=launches["uct_select"] / iters,
         cuda_kernels_in_one_iteration=n_kernels,
         device_ms_in_one_iteration=dev_ms,
         peak_memory_mb=peak_mb, decode_steps_vs_plain=decode_steps,
         kernels_vs_plain=vs_plain)
    return launches, flash_by_body


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
            for body_record in r.get("bodies", {}).values():
                body_record["launches"] = 0
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    launches, rate = phase_search(torch, args.playouts)
    seq_rate = phase_sequential(torch, args.sequential_playouts)
    sweep_launches = phase_paper_sweep(torch, seq_rate)
    phase_search_metrics(torch)
    phase_trace_fit(torch)
    forest_launches, forest_rate = phase_hex_forest(torch)
    gomoku_launches, gomoku_rate = phase_gomoku(torch)
    lm_launches, flash_by_body = phase_lm_search(torch)
    for r in records:
        # each kernel's count on the paths it serves, each path's counters
        # zeroed just before it ran: select_descent and hex_playout on the
        # Hex search, the paper's sweep and the Hex forest; select_descent
        # on Gomoku (its
        # playout has no kernel); uct_select (the LM descent's tile),
        # flash_attention and rmsnorm on the LM search; hex_winner judges
        # filled boards, which no path asks for
        by_path = {"hex_search": launches.get(r["name"], 0),
                   "paper_sweep": sweep_launches.get(r["name"], 0),
                   "hex_forest": forest_launches.get(r["name"], 0),
                   "gomoku": gomoku_launches.get(r["name"], 0),
                   "lm_search": lm_launches.get(r["name"], 0)}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        for body, body_record in r.get("bodies", {}).items():
            body_record["launches"] = flash_by_body[body]   # the LM path's
    emit("summary", seconds=round(time.perf_counter() - t0, 1),
         search_playouts_per_s=rate, sequential_playouts_per_s=seq_rate,
         forest_playouts_per_s=forest_rate, gomoku_playouts_per_s=gomoku_rate)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
