#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (printing ``ptxas``'s registers, shared memory and spill bytes
for each), holds each against its plain PyTorch version on the card — the
Hex path's ``select_descent`` (a whole selection round in one launch) and
``hex_playout`` (a whole playout in one launch), every game path's
``propose_move`` (the move proposal in one launch), the one-tile
``uct_select`` and ``hex_winner``, both bodies of ``flash_attention``, the
bf16 tensor-core one and the CUDA-core one, and ``rmsnorm`` — and drives
the port's paths:

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
  moves (16,384 playouts a member, then ``reroot_forest`` at the visit-sum
  move and two warm moves of 8,192), checking that each sync iteration
  launches ``select_descent`` once per selection round and ``hex_playout``
  once for all members, the re-root retention contract on every member
  after every move, and at 4,096 playouts a member that each member equals
  ``gscpm_search`` with its member key, that kernels equal the plain
  versions and that the forest run twice is bit-identical;
- the same forest sharded over an ensemble mesh (``hex_forest_sharded``,
  8,192 playouts a member, root sync every 4 rounds): on one device, then
  on 2 and 3 virtual shards of the card (3 pads one member) and on every
  card when the host has several, each sharded run equal to the one-device
  run in every forest field and in its merged answers, ``select_descent``
  and ``hex_playout`` launched once a shard a sync iteration; a warm move
  after ``reroot_forest`` on 2 shards, the rates in turns (2,048 playouts a
  member), metrics on at that budget on 2 shards, and a forest tenant of
  4 x 4,096 served over 2 shards equal to the batch search;
- Gomoku on the 15x15 board: a 65,536-playout search on 256 lanes, then
  ``reroot_tree`` and a warm second move, its descent through
  ``select_descent`` (225 children a node), kernels against plain versions,
  and a won position that must stop the descent;
- serving board-game search (``repro_torch.serve.games``, ``serve_games``):
  the TPFIFO engine with 2 slots a game class, quanta of 2 rounds and
  preemption after 2 quanta, 256 lanes, serving 16 requests alternating
  Hex 11x11 and Gomoku 15x15 (8,192 to 32,768 playouts each) and a Hex
  forest tenant of 4 trees; a preempted request of each class equals its
  direct ``gscpm_search``, the forest tenant ``gscpm_search_batch``, the
  first 6 served again blocking, pipelined and one request a slot run to
  completion (``one_per_core``) equal the main run's answers; two sessions
  play 4 Hex moves with the re-root contract held and a warm move equal to
  its direct reference; a seeded fault plan's answers equal the fault-free
  ones; one engine tick profiled (CUDA activity);
- GSCPM-guided decoding on SmolLM-135M at its published width (random
  weights from seed 0): ``repro_torch.serve.mcts_decode.mcts_generate`` of 2
  tokens after a 128-token prompt, 128 playouts a token on 64 lanes, run twice
  with bit-identical tokens and trees, then once more, and one
  search stepped side by side, with the kernels' plain versions;
- LM serving on the same model: B = 4 token trees searched as one forest
  (``lm_batch``: ``mcts_generate_batch`` of 1 token for 4 prompts of
  128, 112, 96 and 128 tokens, 64 lanes a member, 128 playouts a token;
  one ``uct_select`` launch a descent level for all 256 lanes, a masked
  member left empty, run twice bit-identical, kernels against plain
  versions member by member, in turns against 4 single searches), the
  slot engines on a Poisson trace of 16 requests (``lm_serve``: the TPFIFO
  engine at grain 8 and the lockstep ``SlotEngine``; grain 4 and
  preemption give the same tokens), and search-guided serving
  (``lm_mcts_serve``: ``TPFIFOMCTSEngine`` and ``MCTSSlotEngine`` over 6
  requests, the first tick equal to a direct batched search);
- the MoE, MLA, hybrid and xLSTM families at their published widths
  (``lm_families``, bf16, random weights, one model at a time):
  qwen3-moe-235b-a22b and deepseek-v2-236b cut to their first 2 layers,
  zamba2-7b and xlstm-1.3b whole; each serves 4 requests of 8 greedy
  tokens through ``SlotEngine`` and ``TPFIFOEngine`` (run twice, the same
  tokens), its logits held against the plain versions in float32 and
  bf16 (the MoE runs on one routing, every parting of the plain run's own
  a near-tie), and xlstm-1.3b one search-guided token (``MCTSSlotEngine``,
  64 lanes, 128 playouts), with rmsnorm at the families' widths and flash
  at qwen3-moe's and zamba2's head dims held and timed;
- the vlm and encoder-decoder families at their published widths
  (``lm_vlm_encdec``, bf16, random weights, one model at a time):
  paligemma-3b (18 layers) and seamless-m4t-medium (12 + 12 layers) whole;
  each prefills 4 requests of 256 seeded patches or frames and 64 tokens,
  then takes 16 greedy steps (twice, the same tokens), its logits held
  against the plain versions; seamless also one search-guided token
  (``mcts_decode_search``, 64 lanes, 128 playouts) and one batched token
  for the 4 requests (``mcts_decode_search_batch``), each run twice
  bit-identical and, on float32 weights, equal to its run with the plain
  versions; paligemma's search with patches is refused (its prefix does
  not fit the search's cache, as in the reference) before any kernel;
- training at smollm-135m's full width (``lm_train``, bf16, flash on,
  seed-0 weights): ``repro_torch.train.loop.train`` for 40 AdamW steps of
  8 x 256 synthetic tokens in 2 microbatches, an async checkpoint at step
  20 restored bit for bit and resumed for 10 steps (the straight run's
  losses), the loss falling by at least a nat, every norm and attention
  launched as its kernel under autograd (122 and 60 a step, each with one
  backward through its plain version, no plain forward), and gradients
  with the kernels against the plain versions (float32 with flash off and
  on, the bf16 loss, each kernel's gradient at the training shapes in both
  rmsnorm orders and on both flash bodies);
- three cells of the dry-run's shapes at published widths against their
  roofline (``lm_roofline``, bf16, flash on, seed-0 weights, only the
  global batch cut): smollm-135m's train_4k step at 8 x 4,096 tokens,
  qwen1.5-0.5b's prefill_32k at 1 x 32,768 and llama3-8b's decode_32k step
  for 8 rows against a 32,768-row cache. Each is counted on ``meta`` by
  the port's dry-run (``repro_torch.launch.dryrun``: FLOPs, bytes, the
  roofline terms, the peak of live storages, the kernel calls a step) and
  timed on the card; no step may beat its compute term or the time to
  move its arguments and outputs once, the dry-run's peak must lie within
  0.5-2x of the card's, and each kernel must launch as often as the
  dry-run called it;
- one rank's share of two full-width decode cells on the single-pod
  (16, 16) mesh (``lm_sharded``, bf16, every layer, flash off): this
  process is rank 0 of a ``"fake"`` process group of 256 ranks, whose
  collectives move nothing; llama3-8b and qwen3-moe-235b-a22b (all 94
  layers, ~470 GB whole) x decode_32k are counted per rank by the sharded
  dry-run on ``meta``, rank 0's shards are made directly on the card
  (~1.8 GB of the MoE's weights, ~3.2 GB of its cache) and 1 warm and 3
  timed decode steps run under DTensor; rmsnorm must launch as often as
  the count calls it, no step may beat the rank's compute term or one pass
  over its arguments and outputs, and the count's peak must lie within
  0.5-2x of the card's. Values are not checked: a fake collective's output
  is uninitialized memory;
- training on a mesh (``lm_sharded_train``): ``train.loop.train(mesh=)`` on
  a real process group of this process alone (nccl), a (1, 1) mesh on the
  card, the reduced smollm-135m twin for 5 steps with the unsharded loop's
  losses, one step with the kernels against the plain versions, and the
  int8 gradient quantization bit for bit the CPU's; then rank 0 of a fake
  group of 256 on the (16, 16) mesh runs its share of llama3-8b x train_4k
  at full width (32 layers, bf16 params, float32 moments, 4 microbatches
  of 64 x 4,096 tokens, flash off), counted by the sharded dry-run first,
  1 warm, 2 timed and a profiled step through ``jit_train_step``; rmsnorm
  must launch (and take its plain backward) as often as the count says, no
  step may beat the rank's compute term or one pass over its arguments,
  and the count's peak must lie within 0.5-2x of the card's.

``lm_kernels`` also holds and times flash attention, rmsnorm and the
one-tile ``uct_select`` at LM serving's shapes (``new_shapes``), the
families' (``families_shapes``) and the vlm and encdec models'
(``vlm_encdec_shapes``) and the roofline cells' (``roofline_shapes``),
and rmsnorm and flash at the training shapes with their autograd
backwards (``rmsnorm_train_shape``, ``flash_train_shape``).

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
T_START = time.perf_counter()
sys.path.insert(0, os.path.join(HERE, "src"))

# published peaks of one H100 SXM (NVIDIA data sheet, the port's
# roofline.hw). A kernel's bound is the larger of bytes / memory rate and
# operations / rate; the integer and float32 work of these kernels runs
# outside the tensor cores, so the rate is the 67 T/s float32 figure; the
# dense bf16 tensor-core rate is the rate for attention's products on bf16
# inputs.
from repro_torch.roofline.hw import (BF16_TENSOR_OPS_PER_S,  # noqa: E402
                                     HBM_BYTES_PER_S, OPS_PER_S)

# the paper's configuration: 11x11 Hex, 256 lanes, 1024 tasks, fifo, Cp = 1
FULL = dict(board_size=11, n_workers=256, n_tasks=1024, tree_cap=1 << 18,
            scheduler="fifo", cp=1.0, vl_rounds=1)
# the paper's budget; 65,536 playouts with tree_cap 1 << 18 is the cut-down
# run (`--playouts 65536`) for when the time limit is short
PAPER_PLAYOUTS = 1_048_576
SHORT_PLAYOUTS = 65_536
# CUDA kernels one profiled Hex sync iteration may launch: the descent, the
# proposal and the playout are one launch each, the rest (threefry keys,
# expansion, backup) ~300 eager ops; the same bound holds a forest's
# iteration (one pass for all members)
MAX_KERNELS_PER_ITERATION = 800

# the paper's grain-size experiment (Fig 7) at the card's width: 65,536
# playouts a point, fifo and rebalance at these task counts, and one task a
# lane (one_per_core); the trace fit's three grains, fifo
PAPER_SWEEP_TASKS = (64, 256, 1024, 4096)
TRACE_FIT_TASKS = (256, 1024, 4096)
# the counters against the plain versions: a budget where the plain
# descent's level loop (a host read a level) is affordable (8,192 until
# lm_sharded_train needed the time)
METRICS_CHECK_PLAYOUTS = 4096

# the root-parallel forest path: 8 trees of 32 lanes (256 lanes a launch,
# the single tree's width), 128 tasks a member (grain 512 on the first
# move), 16,384 playouts a member (an eighth of the paper's budget over
# the ensemble, to keep the script inside its time limit: 65,536 until the
# lm_sharded phase needed the time, 32,768 until lm_sharded_train did);
# then the visit-sum move is played,
# the forest re-rooted, and two warm moves searched at 8,192 playouts a
# member (16,384 until then)
FOREST = dict(board_size=11, n_workers=32, n_tasks=128, tree_cap=1 << 18,
              scheduler="fifo", cp=1.0, vl_rounds=1)
FOREST_TREES = 8
FOREST_PLAYOUTS = (16_384, 8_192, 8_192)
# the forest's checks: 4 members at 4,096 playouts each (8,192 until
# lm_sharded_train needed the time)
FOREST_CHECK = dict(n_trees=4, n_playouts=4096)
# the forest sharded over an ensemble mesh (hex_forest_sharded): the same
# FOREST at 8,192 playouts a member (16,384 until lm_sharded_train needed
# the time), root sync every 4 rounds, on one
# device, then on 2 and 3 virtual shards of the card (8 members on 3 shards
# pad one) and on every card when there are several; a warm move (2,048
# playouts a member after reroot_forest) on 2 shards; the rates in turns at
# 2,048 playouts a member, then metrics on at that budget on 2 shards; a
# served forest tenant of 4 x 4,096 (the serving engine's lanes and grain;
# 8,192 at grain 16 until then) over 2 shards
SHARDED_PLAYOUTS = 8_192
SHARDED_MERGE_EVERY = 4
SHARDED_VIRTUAL = (2, 3)
SHARDED_WARM_PLAYOUTS = 2048
SHARDED_TURN_PLAYOUTS = 2048
SHARDED_SERVE = dict(n_trees=4, n_playouts=4096, shards=2)
# Gomoku: free-style, the standard 15x15 board, one tree of 256 lanes,
# 65,536 playouts in 256 tasks, then a re-rooted warm second move
GOMOKU = dict(game="gomoku", board_size=15, n_workers=256, n_tasks=256,
              tree_cap=1 << 17, scheduler="fifo", cp=1.0, vl_rounds=1)
GOMOKU_PLAYOUTS = (65_536, 65_536)
GOMOKU_CHECK_PLAYOUTS = 8192

# serving board-game search (repro_torch.serve.games): the TPFIFO engine
# with 2 slots a game class, quanta of 2 schedule rounds, preemption after
# 2 quanta, 256 lanes; 16 requests alternating Hex 11x11 and Gomoku 15x15,
# each of 8,192, 16,384 or 32,768 playouts (drawn from seed 0) in tasks of
# grain 8 (4 to 16 rounds), then one Hex forest tenant of 4 trees; every
# serving budget and the grain are half what they were until the
# lm_sharded_train phase needed the time (the same rounds, quanta and
# preemptions, half the iterations a round)
SERVE_ENGINE = dict(n_slots=2, grain=2, preempt_quanta=2, n_workers=256,
                    tree_cap=1 << 17)
SERVE_GAMES = (("hex", 11), ("gomoku", 15))
SERVE_REQUESTS = 16
SERVE_PLAYOUTS = (8_192, 16_384, 32_768)
SERVE_GRAIN = 8
SERVE_FOREST = dict(n_trees=4, n_playouts=4096)
SERVE_BLOCKING = 6          # the first 6 served again, pipelining off
# two sessions following one game of Hex 11x11 at 16,384 playouts a move;
# which session answers each move (session 2 answers moves 1 and 2, so its
# warm search at move 2 starts from its own answer's subtree)
SESSION_MOVES = 4
SESSION_ANSWERS = (1, 2, 2, 1)
SESSION_PLAYOUTS = 16_384
# chaos: the seeded fault plan over 8 requests of 2,048 and 4,096 playouts
# at a small tree capacity (a snapshot a quantum stays cheap)
CHAOS_PLAN = dict(seed=0, n_ticks=4096, n_slots=4, rate=0.05)
CHAOS_REQUESTS = 8
CHAOS_PLAYOUTS = (2048, 4096)
CHAOS_TREE_CAP = 1 << 14
# the profiled tick: a Hex and a Gomoku request of 4 rounds, past their
# first quantum
TICK_PLAYOUTS = 8_192

# the LM path: SmolLM-135M at full width, one request, a 128-token prompt,
# 2 generated tokens (the second search starts from the committed first),
# each from a GSCPM search of 128 playouts on 64 lanes (1,024 until the
# training phase needed the time, 512 until the lm_sharded phase did, 256
# until lm_sharded_train did: PERF.md §4)
LM_PROMPT_LEN = 128
LM_TOKENS = 2
LM_PLAYOUTS = 128
LM_SEARCH = dict(n_workers=64, n_tasks=64, branch=8, max_depth=6,
                 rollout_len=8, tree_cap=4096)
LM_PREFILL_SHAPE = (64, 9, 3, LM_PROMPT_LEN, 64)   # B, H, Hkv, S, d
LM_DECODE_NORM_SHAPE = (64, 576)                  # W rows of d_model
# LM serving, on the same model and weights:
# - lm_batch: B = 4 prompts left-aligned in a (4, 128) matrix (true lengths
#   128, 112, 96, 128) searched as one forest at the LM_SEARCH width, 128
#   playouts a token (64 tasks of grain 2 on 64 lanes: one round of 2 sync
#   iterations; 256 until the lm_roofline phase came), 2 tokens generated
#   by mcts_generate_batch;
LM_BATCH_LENS = (128, 112, 96, 128)
LM_BATCH_TOKENS = 2
LM_BATCH_PLAYOUTS = 128
LM_BATCH_MASK = (True, True, False, True)
# - lm_serve: a Poisson trace (benchmarks_torch.tpfifo.make_trace) of 16
#   requests, prompts of 16-48 tokens and every third 96-160, 16 new tokens
#   each (32 until the lm_sharded phase needed the time), no eos;
#   TPFIFOEngine(8 slots, max_len 256, grain 8, fifo), then the same trace
#   through SlotEngine(8 slots, max_len 256);
LM_SERVE_TRACE = dict(n_requests=16, rate_rps=4.0, max_new=16,
                      short_lens=(16, 48), long_lens=(96, 160), seed=0)
LM_SERVE_ENGINE = dict(n_slots=8, max_len=256)
LM_SERVE_GRAIN = 8
# - lm_mcts_serve: 6 requests of 32-128-token prompts, 2 new tokens each,
#   through TPFIFOMCTSEngine(4 slots, grain 1, preemption after 1 quantum)
#   and MCTSSlotEngine(4 slots), at lm_batch's search configuration with
#   128 playouts a token (256, lm_batch's, until the training phase needed
#   the time: PERF.md §4)
LM_MCTS_REQUESTS = 6
LM_MCTS_PLAYOUTS = 128
LM_MCTS_PROMPTS = (32, 128)
LM_MCTS_MAX_NEW = 2
LM_MCTS_MAX_PROMPT_LEN = 136
LM_MCTS_SLOTS = 4
# - lm_families: the MoE, MLA, hybrid and xLSTM models at their published
#   widths, bf16, random weights from seed 0, one at a time; the two 235B
#   MoE models cut to their first 2 layers (deepseek-v2: the dense MLA
#   layer and one MoE layer) to fit one card, zamba2-7b and xlstm-1.3b
#   whole. Each serves 4 requests of 32-128-token prompts, 8 greedy new
#   tokens (16 until the lm_sharded phase needed the time), through
#   SlotEngine and TPFIFOEngine (4 slots, max_len 160,
#   grain 8); xlstm-1.3b also one search-guided token (MCTSSlotEngine, the
#   LM_SEARCH width, 128 playouts). The logits check prefills 64 tokens
#   of 4 rows and decodes 2 steps.
LM_FAMILIES = {"qwen3-moe-235b-a22b": dict(n_layers=2, use_flash=True),
               "deepseek-v2-236b": dict(n_layers=2, use_flash=False),
               "zamba2-7b": dict(use_flash=True),
               "xlstm-1.3b": dict(use_flash=False)}
LM_FAMILY_LENS = (32, 64, 96, 128)
LM_FAMILY_MAX_NEW = 8
LM_FAMILY_MAX_LEN = 160
LM_FAMILY_GRAIN = 8
LM_FAMILY_CHECK_LEN = 64
LM_FAMILY_MCTS_ARCH = "xlstm-1.3b"
LM_FAMILY_MCTS_PLAYOUTS = 128
# the families' logits, kernels vs plain versions: in float32 to 1e-3 of
# the largest logit (observed 6e-5-1.2e-4 on zamba2-7b and xlstm-1.3b:
# float32 sums in another order through 81 / 48 layers); in bf16 the
# kernel run at most 1.1x as far (RMS) from the float32 plain run as the
# plain bf16 run (observed 0.98-1.00x)
FAMILY_F32_TOL = 1e-3
FAMILY_BF16_RMS_RATIO = 1.1
# the families' new rmsnorm widths (D, which norm) on 4 decode rows and a
# 128-token prefill's rows, and their flash shapes (B, H, Hkv, S, d)
FAMILY_NORM_WIDTHS = ((4096, "qwen3-moe d_model; xLSTM mLSTM inner"),
                      (5120, "deepseek-v2 d_model"),
                      (3584, "zamba2 d_model"), (2048, "xLSTM d_model"),
                      (1536, "MLA q_norm"), (512, "MLA kv_norm"),
                      (7168, "Mamba-2 gated norm (d_inner)"))
FAMILY_NORM_ROWS = (4, 128)
FAMILY_FLASH_SHAPES = (((1, 64, 4, 128, 128), "qwen3-moe prefill"),
                       ((1, 32, 32, 128, 112), "zamba2 shared attention"))
# - lm_vlm_encdec: paligemma-3b (18 layers, MQA at head dim 256, tanh
#   gelu) and seamless-m4t-medium (12 encoder + 12 decoder layers) whole at
#   their published widths, bf16, seed-0 random weights, use_flash, one at
#   a time. Traffic: VE_ROWS rows of VE_SRC_LEN seeded patches (width 1152,
#   as models.vlm.fake_patches makes them) or frames (width 1024) and
#   VE_PROMPT_LEN seeded tokens, a prefill, then VE_DECODE_STEPS greedy
#   steps. On seamless also one search-guided token (mcts_decode_search, the
#   LM_SEARCH width, VE_SEARCH_PLAYOUTS playouts) and one batched token for
#   the VE_ROWS requests (mcts_decode_search_batch, 64 lanes a request).
VE_MODELS = ("paligemma-3b", "seamless-m4t-medium")
VE_ROWS = 4
VE_SRC_LEN = 256
VE_PROMPT_LEN = 64
VE_DECODE_STEPS = 16
VE_SEARCH_PLAYOUTS = 128      # 256 until lm_sharded_train needed the time
# the two models' rmsnorm widths (D, which norm, the path's row counts):
# paligemma's 4 decode rows and its 4 x 320-position prefill; seamless's 4
# decode rows, its 4 x 64-token decoder prefill (also the batched search's
# decode lanes), its 4 x 256-frame encoder, and the single search's encoder
# on 64 lanes (also the batched search's decoder prefill); and seamless's
# decoder prefill for flash (B, H, Hkv, S, d)
VE_NORM_SHAPES = (
    (2048, "paligemma-3b d_model", (VE_ROWS, VE_ROWS * (VE_SRC_LEN
                                                        + VE_PROMPT_LEN))),
    (1024, "seamless-m4t-medium d_model",
     (VE_ROWS, VE_ROWS * VE_PROMPT_LEN, VE_ROWS * VE_SRC_LEN,
      LM_SEARCH["n_workers"] * VE_SRC_LEN)))
VE_FLASH_SHAPE = ((VE_ROWS, 16, 16, VE_PROMPT_LEN, 64),
                  "seamless-m4t-medium decoder prefill")
# float32 search trees, kernels vs plain versions: every field but wins
# equal, wins within this relative tolerance (values are exp(mean logp) of
# logits that differ by float32 rounding); else the searches are stepped
# side by side and must part only at decisions their error explains
VE_WINS_RTOL = 1e-4
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
# double-buffered loop turns 16 times), the tensor-core body at d = 128, 96
# and 112 (zamba2's), and bf16 at d = 48, which goes to the CUDA-core body
FLASH_CASES = [
    (64, 9, 3, 128, 64), (2, 4, 2, 128, 64), (1, 8, 1, 128, 128),
    (2, 2, 2, 128, 80), (2, 4, 2, 129, 64), (3, 6, 2, 200, 64),
    (1, 2, 1, 1, 64), (2, 4, 4, 37, 32), (2, 9, 3, 1024, 64),
    (2, 8, 2, 200, 128), (1, 8, 2, 1024, 128), (2, 4, 2, 300, 96),
    (2, 2, 1, 77, 48), (2, 4, 2, 200, 112)]
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
# lm_train: smollm-135m at full width (bf16, seed-0 weights, flash on),
# the synthetic pipeline's Zipf tokens, 40 AdamW steps of 8 x 256 tokens in
# 2 microbatches (100 until lm_sharded_train needed the time; the schedule
# still runs to step 100), an async checkpoint at step 20, a resume from it
# for 10
# steps; the loss must fall by LM_TRAIN_DROP nats (first step to the mean
# of the last 10), the resumed steps after the first within
# LM_TRAIN_RESUME_RTOL (the embedding's backward adds by atomics)
LM_TRAIN_DATA = dict(seq_len=256, global_batch=8)
LM_TRAIN_MICRO = 2
LM_TRAIN_STEPS = 40
LM_TRAIN_OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)
LM_TRAIN_CKPT = 20
LM_TRAIN_RESUME_STEPS = 10
LM_TRAIN_DROP = 1.0
LM_TRAIN_RESUME_RTOL = 1e-3
# gradients with the kernels against the plain versions, float32 at full
# width: the loss within 1e-5 relative, each leaf within 1e-3 of its largest
# magnitude
LM_TRAIN_GRAD_LOSS_RTOL = 1e-5
LM_TRAIN_GRAD_TOL = 1e-3
# the training shape of the norm: one microbatch's 4 x 256 rows of d 576
LM_TRAIN_NORM_SHAPE = (4 * 256, 576)
LM_TRAIN_FLASH_SHAPE = (4, 9, 3, 256, 64)      # B, H, Hkv, S, d
# lm_roofline: three cells of the dry-run's shapes at published widths
# (bf16, seed-0 weights, flash on), only the global batch cut; each counted
# on meta by the port's dry-run (launch.dryrun) and measured on the card:
# 1 warm step, then ROOFLINE_STEPS timed (median)
ROOFLINE_CELLS = (("smollm-135m", "train_4k", 8),
                  ("qwen1.5-0.5b", "prefill_32k", 1),
                  ("llama3-8b", "decode_32k", 8))
ROOFLINE_STEPS = 3
# the dry-run's peak memory against the card's, as a ratio
ROOFLINE_PEAK_RATIO = (0.5, 2.0)
# flash is held against the plain version on every head where the plain
# float32 scores take at most ROOFLINE_FLASH_PLAIN_BYTES, else on the first
# ROOFLINE_FLASH_PLAIN_HEADS kv heads' query heads (at the prefill cell's
# 32,768 tokens a head's scores are 4.3 GB)
ROOFLINE_FLASH_PLAIN_BYTES = 8e9
ROOFLINE_FLASH_PLAIN_HEADS = 1
# logits of the full-width bf16 model (prefill, replay and rollout decode
# steps), kernels vs plain versions: both round the same values to bf16 in
# 61 norms and 30 attentions, where a one-ulp difference (2**-8 relative)
# can flip; allowed: 5 % of the largest logit
LOGITS_TOL = 0.05

# lm_sharded: one rank's share of two full-width decode cells (bf16, every
# layer, use_flash off as in the sharded dry-run) on the single-pod mesh,
# this process rank 0 of a fake process group of 256 ranks on the card
LM_SHARDED_CELLS = ("llama3-8b", "qwen3-moe-235b-a22b")
LM_SHARDED_SHAPE = "decode_32k"
LM_SHARDED_STEPS = 3
LM_SHARDED_PEAK_RATIO = (0.5, 2.0)
# lm_sharded_train, part (a): train(mesh=) on a real group of one nccl rank,
# a (1, 1) mesh on the card, the reduced smollm-135m twin (float32, flash
# off) for 5 steps against the unsharded loop (rtol 1e-4), one step with the
# kernels against the plain versions (LM_TRAIN_GRAD_LOSS_RTOL), and the
# int8 gradient quantization of a 1e7-element float32 gradient on the card
# against the CPU's, bit for bit
LM_MESH_TRAIN_DATA = dict(seq_len=64, global_batch=8)
LM_MESH_TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)
LM_MESH_TRAIN_STEPS = 5
LM_MESH_TRAIN_RTOL = 1e-4
LM_QUANT_ELEMENTS = 10_000_000
# part (b): rank 0 of a fake group of 256 on the (16, 16) mesh runs its share
# of llama3-8b x train_4k (every layer, bf16 params, float32 moments, the
# count's 4 microbatches, flash off): 1 warm step, LM_SHARDED_TRAIN_STEPS
# timed, one profiled
LM_SHARDED_TRAIN_CELL = ("llama3-8b", "train_4k")
LM_SHARDED_TRAIN_STEPS = 2


def emit(phase: str, **fields) -> None:
    """One JSON line, stamped with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


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
    and 3 levels with one member held at the root; the serving path's forest
    tenant (4 members of 256 lanes at its tree capacity, its config from
    the engine)."""
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
    tenant = serve_traffic()[-1]
    cfg = serve_engine().request_cfg(tenant)
    board = cfg.game_obj.init_board("cuda")
    fs, _ = gscpm_search_batch(board, 1, cfg, rng.key(tenant.seed, "cuda"),
                               n_trees=tenant.n_trees)
    cases.append((f"serving forest tenant: 11x11, E={tenant.n_trees}, "
                  f"cap {cfg.tree_cap}", fs,
                  board.expand(tenant.n_trees, -1).contiguous(),
                  cfg.game_obj, cfg.n_workers))
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


def propose_inputs(torch, tree, board, game, W, seed):
    """Leaves, legal masks and move keys of one selection round on `tree`
    (a forest: (E, W) lanes): the descent kernel's leaves and boards, the
    game's legal mask, and the move keys as the search passes them, a view
    of a (..., 3, 2) key split read through its lane stride."""
    from repro_torch import rng
    from repro_torch.kernels import select_descent as sd
    E = tree.parent.shape[0] if tree.parent.dim() == 2 else None
    lead = (W,) if E is None else (E, W)
    keys = rng.split(rng.split(rng.key(seed, "cuda"), math.prod(lead)), 3)
    keys = keys.view(*lead, 3, 2)
    _, _, leaves, boards, _ = sd.select_descent(
        tree, board, keys[..., 0, :].contiguous(), 1.0, 1e-3,
        game.max_moves + 1)
    return leaves, game.legal_mask(boards), keys[..., 1, :]


def check_propose_move(torch, cases):
    """The proposal kernel against its plain version on the card, bit for
    bit: each case's leaves of one selection round (single trees and
    forests, Hex and Gomoku), a () leaf, terminal and fully expanded leaves
    (every answer -1), and the benchmark's lane count on one tree."""
    from repro_torch import rng
    from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
    from repro_torch.kernels import propose_move as pm, ref
    per_case, lanes = {}, 0

    def held(name, tree, leaf, legal, key, none=False):
        nonlocal lanes
        before = pm.propose_move.launches
        got = pm.propose_move(tree, leaf, legal, key)
        check(pm.propose_move.launches == before + 1,
              f"propose_move ({name}): not one launch")
        want = ref.propose_move(tree, leaf, legal, key)
        check(got.dtype == want.dtype == torch.int32
              and got.shape == want.shape == leaf.shape,
              f"propose_move ({name}): output {got.dtype} {tuple(got.shape)}"
              f" != plain {want.dtype} {tuple(want.shape)}")
        bad = int((got != want).sum())
        check(bad == 0, f"propose_move ({name}): {bad} of {leaf.numel()} "
                        "lanes differ from the plain version")
        check(not none or bool((got == -1).all()),
              f"propose_move ({name}): a lane proposed a move")
        lanes += leaf.numel()
        per_case[name] = {"lanes": leaf.numel(),
                          "no_move": int((got == -1).sum()),
                          "distinct_moves": int(got.unique().numel())}
        return got

    for ci, (name, tree, board, game, W) in enumerate(cases):
        if "held" in name or "virtual loss" in name:
            continue                     # the same leaves as another case
        held(name, tree,
             *propose_inputs(torch, tree, board, game, W, 300 + ci))
    # Gomoku 15x15 at the search's width: 225 cells, 8 a thread
    gcfg = GSCPMConfig(**{**GOMOKU, "tree_cap": 1 << 14}, n_playouts=8192)
    ggame = gcfg.game_obj
    gboard = ggame.init_board("cuda")
    gtree, _ = gscpm_search(gboard, 1, gcfg, rng.key(31, "cuda"))
    leaf, legal, key = propose_inputs(torch, gtree, gboard, ggame, 256, 32)
    held("gomoku 15x15 search", gtree, leaf, legal, key)
    # one lane: the () leaf of the scalar oracles and core/mcts.py
    held("() leaf, gomoku 15x15", gtree, leaf[3], legal[3], key[3])
    # every lane at a fully expanded root, or at a terminal board
    name, tree, board, game, W = next(c for c in cases
                                      if c[0] == "search 11x11")
    check(int(tree.n_children[0]) == game.n_cells,
          "propose_move: the 11x11 root is not fully expanded")
    n = game.n_cells
    full = torch.where(torch.arange(n, device="cuda") % 2 == 0, 1, 2)
    boards = torch.stack([board] * 8 + [full.to(torch.int8)] * 8)
    keys = rng.split(rng.key(41, "cuda"), 16)
    held("fully expanded root and filled boards, hex 11x11", tree,
         torch.zeros(16, dtype=torch.int32, device="cuda"),
         game.legal_mask(boards), keys, none=True)
    won = gboard.clone()
    won[112:117] = 1                              # a five in the middle row
    wkeys = rng.split(rng.key(42, "cuda"), 4)
    held("won gomoku boards", gtree, torch.zeros(4, dtype=torch.int32,
                                                 device="cuda"),
         ggame.legal_mask(won.expand(4, -1).contiguous()), wkeys, none=True)
    # the benchmark's lane count (1,024 x 256) on one 11x11 tree
    leaf, legal, key = propose_inputs(torch, tree, board, game, W, 43)
    reps = (1024 * 256) // W
    big_key = rng.split(rng.key(44, "cuda"), reps * W * 3).view(-1, 3, 2)
    held("262,144 lanes on one 11x11 tree", tree, leaf.repeat(reps),
         legal.repeat(reps, 1), big_key[:, 1, :])
    return {"lanes": lanes, "mismatches": 0, "cases": per_case,
            "max_abs_err": 0}


def propose_work(torch, tree, leaf, legal):
    """(bytes, operations) of one proposal: per lane the legal mask, the
    leaf id, its key, its child count and the move out, each child's id
    and move read once; a uniform for every untried legal cell, and a
    mask test, a compare and a select per cell."""
    from repro_torch.core.tree import gather_nodes, member_rows, rows_view
    N, n = leaf.numel(), legal.shape[-1]
    rows = member_rows(tree, leaf)
    kids = rows_view(tree, tree.n_children)[rows]
    slots = rows_view(tree, tree.children)[rows]
    valid = (torch.arange(tree.max_children, device=leaf.device)
             < kids[..., None])
    moves = torch.where(valid, gather_nodes(
        tree, tree.move, torch.where(valid, slots, tree.cap)), n)
    tried = torch.zeros((*leaf.shape, n + 1), dtype=torch.bool,
                        device=leaf.device)
    tried.scatter_(-1, moves.long(), True)
    draws = int((legal & ~tried[..., :n]).sum())
    n_bytes = N * (n + 4 + 16 + 4 + 4) + 8 * int(kids.long().sum())
    return n_bytes, draws * UNIFORM_OPS + 3 * N * n


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
    """Hold the game-search kernels (the descent, the playout and the
    proposal, the one-tile uct_select and hex_winner) against their plain
    versions on the card, then time them at the shapes the main path gives
    them."""
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

    # the proposal at the main path's shape: one selection round's 256
    # leaves on the same 11x11 tree; then the benchmark's Hex lane count
    # (1,024 x 256), those leaves repeated on that tree
    from repro_torch.kernels import propose_move as pm
    proposal = check_propose_move(torch, cases)
    pleaf, plegal, pkey = propose_inputs(torch, t11, b11, game, W, 45)
    propose_call = lambda: pm.propose_move(t11, pleaf, plegal, pkey)
    pm_ms = time_ms(propose_call)
    pm_graph = graph_ms(propose_call)
    pm_plain = time_ms(lambda: ref.propose_move(t11, pleaf, plegal, pkey),
                       iters=20, warmup=3)
    pm_bytes, pm_ops = propose_work(torch, t11, pleaf, plegal)
    pm_bound, pm_by = bound_ms(pm_bytes, pm_ops, OPS_PER_S)
    reps = 1024
    bleaf, blegal = pleaf.repeat(reps), plegal.repeat(reps, 1)
    bkey = rng.split(rng.key(46, "cuda"), reps * W * 3).view(-1, 3, 2)
    bkey = bkey[:, 1, :]
    big_call = lambda: pm.propose_move(t11, bleaf, blegal, bkey)
    pm_big_ms = time_ms(big_call, iters=50)
    pm_big_graph = graph_ms(big_call, launches=10)
    pm_big_plain = time_ms(
        lambda: ref.propose_move(t11, bleaf, blegal, bkey), iters=3,
        warmup=1, reps=3)
    pm_big_bytes, pm_big_ops = propose_work(torch, t11, bleaf, blegal)
    pm_big_bound, pm_big_by = bound_ms(pm_big_bytes, pm_big_ops, OPS_PER_S)

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
        {"name": "propose_move", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/propose_move.cu",
         "replaces": "no TPU kernel: src/repro/core/gscpm.py's propose_move "
                     "is jnp and jax.random.uniform, fused by XLA",
         "shape": [W, C], "checked": proposal, "max_abs_err": 0,
         "ms": pm_ms, "in_graph_ms": pm_graph, "plain_ms": pm_plain,
         "bound_ms": pm_bound, "bound_by": pm_by, "library_ms": None,
         "timed_on": {"tree": "11x11, 65,536-playout search",
                      "bytes": pm_bytes, "operations": pm_ops},
         "bench_lanes": {"shape": [reps * W, C], "ms": pm_big_ms,
                         "in_graph_ms": pm_big_graph,
                         "plain_ms": pm_big_plain, "bound_ms": pm_big_bound,
                         "bound_by": pm_big_by, "bytes": pm_big_bytes,
                         "operations": pm_big_ops}},
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
         select_descent=descent, hex_playout=playout, propose_move=proposal,
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
    return cuda_activity(prof)


def cuda_activity(prof):
    """(CUDA kernels, their device ms) in a ``torch.profiler`` window; with
    no device trace, (host-side launch calls or None, None)."""
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
    from repro_torch.kernels import propose_move as pm
    from repro_torch.kernels import select_descent as sd, uct_select as us
    return {"select_descent": sd.select_descent, "hex_playout": hp.hex_playout,
            "propose_move": pm.propose_move,
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
    check(launches["propose_move"] == rounds,
          f"propose_move launches {launches['propose_move']} != "
          f"selection rounds {rounds}")
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
    from repro_torch.kernels import propose_move as pm
    board = torch.zeros(121, dtype=torch.int8, device="cuda")
    before = pm.propose_move.launches
    tree, st = uct_search(board, 1, n_playouts, rng.key(0, "cuda"),
                          board_size=11, tree_cap=1 << 14)
    check(float(tree.visits[0]) == n_playouts, "sequential: root visits")
    check(pm.propose_move.launches - before == n_playouts,
          f"sequential: propose_move launches "
          f"{pm.propose_move.launches - before} != playouts {n_playouts} "
          "(one () leaf an iteration)")
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
    check(launches["propose_move"] == rounds,
          f"paper_sweep: propose_move launches {launches['propose_move']} != "
          f"selection rounds {rounds}")
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
    three self-play moves (16,384 playouts a member, then the visit-sum
    move played, the forest re-rooted and two warm moves of 8,192), each
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
    check(launches["propose_move"] == rounds,
          f"forest: propose_move launches {launches['propose_move']} != "
          f"selection rounds {rounds}")
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


# --------------------------------------------------------- sharded forest ----
def sharded_launches_checked(counters, n_shards: int, iterations: int,
                             what: str) -> dict:
    """The search counters after a sharded run: ``select_descent``,
    ``propose_move`` and ``hex_playout`` once a shard a sync iteration, the
    one-tile kernels never."""
    launches = {name: c.launches for name, c in counters.items()}
    for name in ("select_descent", "propose_move", "hex_playout"):
        check(launches[name] == n_shards * iterations,
              f"{what}: {name} launches {launches[name]} != {n_shards} "
              f"shards x {iterations} sync iterations")
    check(launches["uct_select"] == 0 and launches["hex_winner"] == 0,
          f"{what}: the one-tile kernels launched: {launches}")
    return launches


def sharded_equal(torch, f_off, s_off, f_on, s_on, n: int, E: int,
                  what: str) -> None:
    """A sharded run equals the one-device run in every forest field and
    in the stats that do not describe sharding, and its sharding stats
    describe its mesh."""
    from repro_torch.core.tree import Tree
    bad = [name for name, a, b in zip(Tree._fields, f_off, f_on)
           if not torch.equal(a, b)]
    check(not bad, f"{what}: forest fields differ from one device: {bad}")
    for k in ("best_move_sum", "best_move_vote", "member_best_moves",
              "tree_nodes", "playouts", "n_syncs"):
        check(s_on[k] == s_off[k], f"{what}: {k} {s_on[k]} != {s_off[k]}")
    check(s_on["sharded"] is True and s_on["n_devices"] == n
          and s_on["mesh_shape"] == {"ens": n}
          and s_on["padded_members"] == -E % n,
          f"{what}: sharding stats {s_on['sharded']}, {s_on['n_devices']}, "
          f"{s_on['mesh_shape']}, {s_on['padded_members']} do not describe "
          f"a mesh of {n}")


def phase_hex_forest_sharded(torch):
    """The root-parallel forest sharded over an ensemble mesh, at the forest
    path's full width (8 trees of 32 lanes on 11x11, cap 2^18): on one
    device, then on 2 and 3 virtual shards of the card and on every card
    when there are several, each sharded run equal to the one-device run
    field by field and launching each Hex kernel once a shard a sync
    iteration; a warm move on 2 shards; the rates in turns, then metrics on
    at their budget on 2 shards; a forest tenant served over 2 shards equal
    to the batch search."""
    import numpy as np
    from repro_torch import rng
    from repro_torch.core.gscpm import GSCPMConfig
    from repro_torch.core.root_parallel import (check_forest_invariants,
                                                gscpm_search_batch,
                                                merged_root_stats)
    from repro_torch.core.tree import reroot_forest
    from repro_torch.serve.games import GameRequest, TPFIFOGameEngine

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    E = FOREST_TREES
    cfg = GSCPMConfig(**FOREST, n_playouts=SHARDED_PLAYOUTS)
    game = cfg.game_obj
    board = game.init_board("cuda")
    key = rng.key(5, "cuda")
    iters = sync_iterations(cfg)
    counters = search_counters()
    meshes = [["cuda"] * n for n in SHARDED_VIRTUAL]
    if torch.cuda.device_count() > 1:
        meshes.append(None)           # "cuda" alone: every visible card

    def search(c, device, shard, root=board, to_move=1, forest=None):
        """One forest search, the search counters zeroed just before."""
        for ctr in counters.values():
            ctr.launches = 0
        return gscpm_search_batch(root, to_move, c, key, n_trees=E,
                                  merge_every=SHARDED_MERGE_EVERY,
                                  forest=forest, shard=shard, device=device)

    # warm the allocator and the split and gather on a short search
    gscpm_search_batch(board, 1, GSCPMConfig(**{**FOREST, "tree_cap": 1 << 12},
                                             n_playouts=1024), key, n_trees=E,
                       device=["cuda"] * 2, merge_every=SHARDED_MERGE_EVERY)

    f_off, s_off = search(cfg, "cuda", "off")
    runs, path = {"one_device": {"seconds": s_off["time_s"],
                                 "playouts_per_s": s_off["playouts_per_s"],
                                 "n_syncs": s_off["n_syncs"]}}, {}
    for device in meshes:
        f_on, s_on = search(cfg, device, "require")
        n = s_on["n_devices"]
        what = (f"sharded forest, every card ({n})" if device is None
                else f"sharded forest, {n} virtual shards")
        launches = sharded_launches_checked(counters, n, iters, what)
        sharded_equal(torch, f_off, s_off, f_on, s_on, n, E, what)
        for name, v in launches.items():
            path[name] = path.get(name, 0) + v
        runs["all_cards" if device is None else f"virtual_{n}"] = {
            "n_devices": n, "padded_members": s_on["padded_members"],
            "seconds": s_on["time_s"], "playouts_per_s": s_on["playouts_per_s"],
            "launches": launches,
            "launches_per_iteration_per_shard": {
                k: launches[k] / (iters * n)
                for k in ("select_descent", "propose_move", "hex_playout")}}
        if device != ["cuda", "cuda"]:
            del f_on
            continue
        f_two = f_on
    check_forest_invariants(f_two)
    check(torch.equal(f_two.visits[:, 0],
                      torch.full((E,), float(s_off["playouts"]),
                                 device="cuda")),
          "sharded forest: after the last sync a member's root does not "
          "carry the ensemble's playouts")

    # a warm move on 2 shards after reroot_forest, against one device (the
    # one-device search writes the re-rooted forest in place: it goes last)
    mv = s_off["best_move_sum"]
    carry = reroot_forest(f_two, mv)
    del f_off, f_two
    wcfg = GSCPMConfig(**FOREST, n_playouts=SHARDED_WARM_PLAYOUTS)
    wboard = game.place(board, torch.tensor(mv, device="cuda"), 1)
    f_w2, s_w2 = search(wcfg, ["cuda"] * 2, "require", wboard, 2, carry)
    launches = sharded_launches_checked(counters, 2, sync_iterations(wcfg),
                                        "sharded warm move")
    for name, v in launches.items():
        path[name] += v
    f_w1, s_w1 = search(wcfg, "cuda", "off", wboard, 2, carry)
    sharded_equal(torch, f_w1, s_w1, f_w2, s_w2, 2, E, "sharded warm move")
    check(s_w2.get("reused_nodes", 0) == s_w1.get("reused_nodes", 0) > 0,
          "sharded warm move: no retained nodes, or not as on one device")
    warm = {"move": mv, "reused_nodes": s_w2["reused_nodes"],
            "playouts_per_s": s_w2["playouts_per_s"],
            "one_device_playouts_per_s": s_w1["playouts_per_s"]}
    del carry, f_w1, f_w2

    # the rates in turns: one device, 2 shards, 3 shards, then back
    tcfg = GSCPMConfig(**FOREST, n_playouts=SHARDED_TURN_PLAYOUTS)
    order = [("one_device", "cuda", "off")] + [
        (f"virtual_{n}", ["cuda"] * n, "require") for n in SHARDED_VIRTUAL]
    turns = {name: [] for name, _, _ in order}
    for name, device, shard in order + order[::-1]:
        f_t, st = search(tcfg, device, shard)
        turns[name].append(st["playouts_per_s"])
        if name == "one_device":
            f_small, s_small = f_t, st
    for name in turns:
        turns[name].sort()

    # metrics on, on 2 shards at the turns' budget: the one-device forest
    # of the same search, the counters conserved
    mcfg = GSCPMConfig(**FOREST, n_playouts=SHARDED_TURN_PLAYOUTS,
                       metrics=True)
    f_m, s_m = search(mcfg, ["cuda"] * 2, "require")
    m_iters = sync_iterations(mcfg)
    launches = sharded_launches_checked(counters, 2, m_iters,
                                        "sharded forest with metrics")
    for name, v in launches.items():
        path[name] += v
    sharded_equal(torch, f_small, s_small, f_m, s_m, 2, E,
                  "sharded forest with metrics")
    met = s_m["metrics"]
    check(met["lane_playouts"] == s_m["playouts"]
          and met["sync_iterations"] == E * m_iters
          and met["expansions"] == sum(s_m["tree_nodes"]) - E,
          f"sharded forest: metrics not conserved: {met}")
    del f_m, f_t, f_small

    # a forest tenant served over 2 virtual shards == the batch search
    n_po, n_sh = SHARDED_SERVE["n_playouts"], SHARDED_SERVE["shards"]
    for ctr in counters.values():
        ctr.launches = 0
    eng = TPFIFOGameEngine(**SERVE_ENGINE, device=["cuda"] * n_sh)
    req = GameRequest(rid=0, game="hex", board_size=11, n_playouts=n_po,
                      n_tasks=n_po // SERVE_GRAIN, seed=SERVE_REQUESTS + 1,
                      n_trees=SHARDED_SERVE["n_trees"])
    check(eng.submit(req), "sharded serve: request not queued")
    eng.run()
    rcfg = eng.request_cfg(req)
    launches = sharded_launches_checked(counters, n_sh, sync_iterations(rcfg),
                                        "served sharded forest tenant")
    for name, v in launches.items():
        path[name] += v
    fst, bst = gscpm_search_batch(board, 1, rcfg, rng.key(req.seed, "cuda"),
                                  n_trees=req.n_trees, shard="off",
                                  device="cuda")
    mvs, mws = merged_root_stats(fst, game.n_actions)
    res = req.result
    check(res["status"] == "answered"
          and np.array_equal(res["root_visits"], mvs.cpu().numpy())
          and np.array_equal(res["root_wins"], mws.cpu().numpy())
          and res["best_move"] == bst["best_move_sum"]
          and res["best_move_vote"] == bst["best_move_vote"]
          and res["member_best_moves"] == bst["member_best_moves"]
          and res["tree_nodes"] == sum(bst["tree_nodes"]),
          "sharded serve: the forest tenant over 2 shards differs from "
          "gscpm_search_batch on one device")
    del fst

    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    emit("hex_forest_sharded",
         config={**FOREST, "n_trees": E, "playouts_per_member":
                 SHARDED_PLAYOUTS, "merge_every": SHARDED_MERGE_EVERY,
                 "sync_iterations": iters, "cards": torch.cuda.device_count()},
         runs=runs, launches=path, metrics_on_equal=True, warm_move=warm,
         playouts_per_s_in_turns={
             **turns, "config": {"playouts_per_member":
                                 SHARDED_TURN_PLAYOUTS,
                                 "order": [n for n, _, _ in order + order[::-1]]}},
         served_tenant={"n_trees": req.n_trees, "playouts": res["playouts"],
                        "shards": n_sh, "equal": True},
         peak_memory_mb=peak_mb, seconds=time.perf_counter() - t_phase)
    return path


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
    check(launches["propose_move"] == rounds,
          f"gomoku: propose_move launches {launches['propose_move']} != "
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


# ------------------------------------------------------------- serve games ----
SUMMARY_KEYS = ("root_visits", "root_wins", "best_move", "root_value",
                "tree_nodes")


def differing_answer(a: dict, b: dict, keys=SUMMARY_KEYS) -> list:
    """Keys on which two served answers (or root summaries) differ."""
    import numpy as np
    return [k for k in keys
            if not (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
                    else a[k] == b[k])]


def serve_engine(**kw):
    from repro_torch.serve.games import TPFIFOGameEngine
    return TPFIFOGameEngine(**{**SERVE_ENGINE, **kw}, device="cuda")


def serve_traffic():
    """The mixed requests (playouts drawn from seed 0, tasks of grain 8)
    and the Hex forest tenant, as fresh request objects."""
    import numpy as np
    from repro_torch.serve.games import GameRequest
    draw = np.random.default_rng(0)
    reqs = []
    for rid in range(SERVE_REQUESTS):
        game, size = SERVE_GAMES[rid % len(SERVE_GAMES)]
        n = int(draw.choice(SERVE_PLAYOUTS))
        reqs.append(GameRequest(rid=rid, game=game, board_size=size,
                                n_playouts=n, n_tasks=n // SERVE_GRAIN,
                                seed=rid))
    n = SERVE_FOREST["n_playouts"]
    game, size = SERVE_GAMES[0]
    reqs.append(GameRequest(rid=SERVE_REQUESTS, game=game, board_size=size,
                            n_playouts=n, n_tasks=n // SERVE_GRAIN,
                            seed=SERVE_REQUESTS,
                            n_trees=SERVE_FOREST["n_trees"]))
    return reqs


def served_clean(eng, registry, what: str) -> None:
    """A fault-free run: every request answered, no retry, no quarantined
    slot, no result-guard rejection, nothing shed or left over."""
    st = eng.stats()
    check(st.n_retries == 0, f"{what}: {st.n_retries} retries")
    check(st.n_quarantined == 0 and not eng.quarantined,
          f"{what}: quarantined slots {eng.quarantined}")
    guard = registry.snapshot()["metrics"].get(
        "serve_guard_failures_total", {}).get("value", 0)
    check(guard == 0, f"{what}: {guard} result-guard rejections")
    check(st.n_unfinished == 0 and st.n_shed == 0,
          f"{what}: {st.n_unfinished} unfinished, {st.n_shed} shed")
    check(all(r.result["status"] == "answered" for r in eng.finished),
          f"{what}: a request ended other than answered")


def serve_run(torch, reqs, **kw):
    """Serve ``reqs`` on a fresh engine: (engine, registry, wall seconds)."""
    from repro_torch.obsv import MetricsRegistry
    registry = MetricsRegistry()
    eng = serve_engine(registry=registry, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        check(eng.submit(r), f"serve: request {r.rid} not queued")
    eng.run()
    torch.cuda.synchronize()
    return eng, registry, time.perf_counter() - t0


def profile_one_tick(torch):
    """CUDA kernels, device ms and wall ms of one steady engine tick: a Hex
    and a Gomoku request (4 rounds each) past their first quantum, the
    tick that runs the second."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.games import GameRequest
    eng = serve_engine()
    for rid, (game, size) in enumerate(SERVE_GAMES):
        eng.submit(GameRequest(rid=rid, game=game, board_size=size,
                               n_playouts=TICK_PLAYOUTS,
                               n_tasks=TICK_PLAYOUTS // SERVE_GRAIN,
                               seed=rid))
    eng.run(max_ticks=1, on_exhaust="ignore")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(max_ticks=1, on_exhaust="ignore")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    eng.run()
    kernels, device_ms = cuda_activity(prof)
    return {"cuda_kernels": kernels, "device_ms": device_ms,
            "wall_ms": wall_ms, "sync_iterations": 2 * 2 * SERVE_GRAIN,
            "device_idle_share": (1 - device_ms / wall_ms) if device_ms
            else None}


def serve_sessions(torch):
    """Two sessions follow one game of Hex 11x11 move by move, each playing
    every move; session 1 answers moves 0 and 3, session 2 moves 1 and 2,
    so its move-2 search starts from the subtree of its own move-1 answer.
    Every re-root keeps its retention contract, and move 2 equals the
    direct warm reference, made from a clone of the session's tree with
    its fields read before the search (the served search writes into the
    session's tree in place)."""
    import dataclasses
    from repro_torch import rng
    from repro_torch.core.gscpm import gscpm_search
    from repro_torch.core.tree import (Tree, check_reroot_retention,
                                       root_summary)
    from repro_torch.obsv import MetricsRegistry
    from repro_torch.serve import games
    registry = MetricsRegistry()
    eng = serve_engine(registry=registry)
    game, size = SERVE_GAMES[0]
    sessions = {p: games.GameSession(eng, game, size, base_seed=100 * p,
                                     name=f"{game}{size}-s{p}")
                for p in (1, 2)}
    moves, warm_check = [], None
    for mvno in range(SESSION_MOVES):
        side = sessions[1].to_move
        answers = SESSION_ANSWERS[mvno]
        sess = sessions[answers]
        if mvno == 2:
            check(sess.tree is not None, "sessions: no warm tree at move 2")
            clone = Tree(*(x.clone() for x in sess.tree))
            reused_visits = float(clone.visits[0])      # before the search
            reused_nodes = int(clone.n_nodes) - 1
            check(reused_nodes > 0 and reused_visits > 0,
                  f"sessions: move 2's warm tree is empty ({reused_nodes} "
                  f"nodes, {reused_visits} visits below the root)")
            board, to_move = sess.board.clone(), sess.to_move
        req = sess.make_request(n_playouts=SESSION_PLAYOUTS,
                                n_tasks=SESSION_PLAYOUTS // SERVE_GRAIN)
        t0 = time.perf_counter()
        eng.submit(req)
        eng.run()
        seconds = time.perf_counter() - t0
        res = req.result
        if mvno == 2:
            cfg = eng.request_cfg(req)
            po, tasks = games.warm_budget(cfg.n_playouts, cfg.n_tasks,
                                          cfg.n_workers, reused_visits)
            tree, st = gscpm_search(
                board, to_move,
                dataclasses.replace(cfg, n_playouts=po, n_tasks=tasks),
                rng.key(req.seed, "cuda"), tree=clone)
            bad = differing_answer(res, root_summary(tree,
                                                     cfg.game_obj.n_actions))
            check(not bad, f"sessions: move 2 differs from the direct warm "
                           f"reference in {bad}")
            check(res["reused_visits"] == int(reused_visits)
                  and res["reused_nodes"] == reused_nodes
                  and res["playouts"] == st["playouts"],
                  "sessions: move 2's reuse accounting differs from the "
                  "reference's")
            warm_check = {"move": 2, "equal_to_direct_reference": True,
                          "reused_visits": res["reused_visits"],
                          "reused_nodes": reused_nodes,
                          "fresh_playouts": res["playouts"]}
        mv = res["best_move"]
        check(0 <= mv < size * size, f"sessions: move {mvno} off the board")
        retained = {}
        for p, s in sessions.items():
            src = s.tree
            s.play(mv)
            if src is not None:
                retained[p] = check_reroot_retention(src, s.tree, mv)
        moves.append({"move": mvno, "player": side, "session": answers,
                      "best_move": mv,
                      "playouts": res["playouts"],
                      "reused_visits": res.get("reused_visits", 0),
                      "seconds": seconds, "retained_nodes": retained})
    served_clean(eng, registry, "sessions")
    return {"moves": moves, "warm_reference": warm_check}


def serve_chaos(torch):
    """The seeded fault plan over 8 mixed requests: every request answered,
    equal to the same traffic served without faults; at least one retry,
    and no more than the dispatch and poison faults that fired. Then a plan
    that poisons every slot's root statistics after the first tick's
    quantum (in place, on the card): the result guard rejects each poisoned
    answer, the search rolls back to its host snapshot and retries, and the
    answers again equal the fault-free run."""
    from repro_torch.serve.games import GameRequest
    from repro_torch.serve.resilience import (FaultEvent, FaultInjector,
                                              FaultPlan)

    def traffic():
        out = []
        for i in range(CHAOS_REQUESTS):
            game, size = SERVE_GAMES[i % len(SERVE_GAMES)]
            n = CHAOS_PLAYOUTS[i % 4 >= 2]
            out.append(GameRequest(rid=i, game=game, board_size=size,
                                   n_playouts=n, n_tasks=n // SERVE_GRAIN,
                                   seed=1000 + i))
        return out

    injector = FaultInjector(FaultPlan.generate(**CHAOS_PLAN))
    chaos_reqs, calm_reqs = traffic(), traffic()
    eng, _, wall = serve_run(torch, chaos_reqs, tree_cap=CHAOS_TREE_CAP,
                             injector=injector)
    calm, calm_registry, _ = serve_run(torch, calm_reqs,
                                       tree_cap=CHAOS_TREE_CAP)
    served_clean(calm, calm_registry, "chaos: the fault-free run")
    for a, b in zip(chaos_reqs, calm_reqs):
        check(a.result["status"] == "answered",
              f"chaos: request {a.rid} ended {a.result['status']}")
        bad = differing_answer(a.result, b.result,
                               SUMMARY_KEYS + ("playouts", "rounds"))
        check(not bad, f"chaos: request {a.rid} differs from the fault-free "
                       f"run in {bad}")
    st = eng.stats()
    fired = dict(injector.fired)
    hits = fired.get("dispatch_error", 0) + fired.get("poison_nan", 0)
    check(1 <= st.n_retries <= hits,
          f"chaos: {st.n_retries} retries for {hits} dispatch and poison "
          f"faults fired")

    poison = FaultPlan(events=tuple(FaultEvent(tick=0, slot=s,
                                               kind="poison_nan")
                                    for s in range(CHAOS_PLAN["n_slots"])))
    p_injector = FaultInjector(poison)
    p_reqs = traffic()
    p_eng, p_registry, _ = serve_run(torch, p_reqs, tree_cap=CHAOS_TREE_CAP,
                                     injector=p_injector)
    for a, b in zip(p_reqs, calm_reqs):
        check(a.result["status"] == "answered",
              f"poison: request {a.rid} ended {a.result['status']}")
        bad = differing_answer(a.result, b.result,
                               SUMMARY_KEYS + ("playouts", "rounds"))
        check(not bad, f"poison: request {a.rid} differs from the fault-free "
                       f"run in {bad}")
    p_st = p_eng.stats()
    poisoned = p_injector.fired.get("poison_nan", 0)
    rejected = p_registry.snapshot()["metrics"].get(
        "serve_guard_failures_total", {}).get("value", 0)
    check(poisoned >= 1 and 1 <= rejected <= poisoned
          and rejected <= p_st.n_retries <= poisoned,
          f"poison: {poisoned} poisoned, {rejected} guard rejections, "
          f"{p_st.n_retries} retries")
    return {"plan": CHAOS_PLAN, "tree_cap": CHAOS_TREE_CAP,
            "faults_fired": fired, "retries": st.n_retries,
            "quarantined": st.n_quarantined, "seconds": wall,
            "snapshot_device_wait_s": st.device_wait_s,
            "equal_to_fault_free": True,
            "poison": {"slots_poisoned_at_tick_0": poisoned,
                       "guard_rejections": rejected,
                       "retries": p_st.n_retries,
                       "quarantined": p_st.n_quarantined,
                       "equal_to_fault_free": True}}


def phase_serve_games(torch):
    """Serving board-game search at full width (``repro_torch.serve.games``):
    mixed Hex 11x11 and Gomoku 15x15 traffic and a forest tenant through
    the TPFIFO engine, each class's searches preempted between quanta yet
    equal to direct searches; pipelined equal to blocking and to one
    request a slot run to completion (one_per_core); sessions; chaos."""
    import numpy as np
    from repro_torch import rng
    from repro_torch.core.gscpm import gscpm_search
    from repro_torch.core.root_parallel import (gscpm_search_batch,
                                                merged_root_stats)
    from repro_torch.core.scheduler import make_schedule
    from repro_torch.core.tree import root_summary
    from repro_torch.obsv import MetricsRegistry
    from repro_torch.obsv.trace import kernel_builds
    from repro_torch.serve.games import GameRequest

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # warm the allocator and every op of both classes on a short serve
    serve_run(torch, [GameRequest(rid=i, game=g, board_size=size,
                                  n_playouts=2048, n_tasks=128, seed=i)
                      for i, (g, size) in enumerate(SERVE_GAMES)])

    # the main path: counts to 0 just before, read just after
    reqs = serve_traffic()
    registry = MetricsRegistry()
    eng = serve_engine(registry=registry)
    counters = search_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        check(eng.submit(r), f"serve: request {r.rid} not queued")
    eng.run(max_ticks=1, on_exhaust="ignore")     # the first quantum
    builds = kernel_builds()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    check(kernel_builds() == builds,
          "serve: the kernel library was built after the first quantum")
    check(eng.pipeline, "serve: pipelining is off on the main path")
    check(len(eng.finished) == len(reqs), "serve: a request was not answered")
    served_clean(eng, registry, "serve")

    iters = {r.rid: sync_iterations(eng.request_cfg(r)) for r in reqs}
    rounds = sum(iters.values()) * eng.template.vl_rounds
    hex_iters = sum(iters[r.rid] for r in reqs if r.game == "hex")
    check(launches["select_descent"] == rounds,
          f"serve: select_descent launches {launches['select_descent']} != "
          f"selection rounds {rounds}")
    check(launches["propose_move"] == rounds,
          f"serve: propose_move launches {launches['propose_move']} != "
          f"selection rounds {rounds}")
    check(launches["hex_playout"] == hex_iters,
          f"serve: hex_playout launches {launches['hex_playout']} != Hex "
          f"sync iterations {hex_iters}")
    check(launches["uct_select"] == 0 and launches["hex_winner"] == 0,
          f"serve: the one-tile kernels launched: {launches}")
    for r in reqs:
        cfg = eng.request_cfg(r)
        want = r.n_trees * sum(
            int(x.active.sum()) * x.m for x in make_schedule(
                cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler))
        check(r.result["playouts"] == want
              and float(r.result["root_visits"].sum()) == want,
              f"serve: request {r.rid} committed other than its budget")
    preempted = {g: [t.req for t in eng.finished_tickets
                     if t.req.game == g and t.preemptions > 0
                     and t.req.n_trees == 1] for g, _ in SERVE_GAMES}
    check(all(preempted.values()),
          f"serve: a class saw no preemption: "
          f"{ {g: len(v) for g, v in preempted.items()} }")
    stats = eng.stats()
    served_playouts = sum(r.result["playouts"] for r in reqs)

    # a preempted request of each class == its uninterrupted search
    direct = {}
    for g, _ in SERVE_GAMES:
        r = min(preempted[g], key=lambda q: q.n_playouts)
        cfg = eng.request_cfg(r)
        tree, _ = gscpm_search(cfg.game_obj.init_board("cuda"), r.to_move,
                               cfg, rng.key(r.seed, "cuda"))
        bad = differing_answer(r.result,
                               root_summary(tree, cfg.game_obj.n_actions))
        check(not bad, f"serve: preempted {g} request {r.rid} differs from "
                       f"gscpm_search in {bad}")
        direct[g] = {"rid": r.rid, "playouts": r.n_playouts,
                     "preemptions": r.result["preemptions"], "equal": True}
        del tree
    # the forest tenant == gscpm_search_batch
    f = reqs[-1]
    cfg = eng.request_cfg(f)
    forest, fst = gscpm_search_batch(cfg.game_obj.init_board("cuda"), 1, cfg,
                                     rng.key(f.seed, "cuda"),
                                     n_trees=f.n_trees)
    mv, mw = merged_root_stats(forest, cfg.game_obj.n_actions)
    res = f.result
    check(np.array_equal(res["root_visits"], mv.cpu().numpy())
          and np.array_equal(res["root_wins"], mw.cpu().numpy())
          and res["best_move"] == fst["best_move_sum"]
          and res["best_move_vote"] == fst["best_move_vote"]
          and res["member_best_moves"] == fst["member_best_moves"]
          and res["tree_nodes"] == sum(fst["tree_nodes"]),
          "serve: the forest tenant differs from gscpm_search_batch")
    direct["forest"] = {"rid": f.rid, "n_trees": f.n_trees, "equal": True}
    del forest

    # the first 6 again, blocking then pipelined: answers equal the main
    # run's, and device_wait_s on equal traffic
    again = {}
    for pipeline in (False, True):
        sub = [fresh_request(r) for r in reqs[:SERVE_BLOCKING]]
        e2, reg2, w2 = serve_run(torch, sub, pipeline=pipeline)
        check(e2.pipeline == pipeline, "serve: pipelining mode not as asked")
        served_clean(e2, reg2, f"serve again, pipeline={pipeline}")
        for a, b in zip(sub, reqs):
            bad = differing_answer(a.result, b.result,
                                   SUMMARY_KEYS + ("playouts", "rounds"))
            check(not bad, f"serve: request {a.rid} with pipeline={pipeline}"
                           f" differs from the main run in {bad}")
        again["pipelined" if pipeline else "blocking"] = served_arm(
            e2, sub, w2)
    # and run to completion, one request a slot (the paper's one task a
    # core): each answer equals the main run's, since a search's round
    # randomness depends on its key and task ids, not on its quanta.
    # Blocking retirement, as the fifo rerun it is read beside: a pipelined
    # engine stamps a retirement after the next tick's launches, and a
    # one_per_core tick spans whole searches
    sub = [fresh_request(r) for r in reqs[:SERVE_BLOCKING]]
    e3, reg3, w3 = serve_run(torch, sub, policy="one_per_core",
                             preempt_quanta=None, pipeline=False)
    served_clean(e3, reg3, "serve again, one_per_core")
    check(e3.stats().n_preemptions == 0,
          "serve: the one_per_core engine preempted a request")
    for a, b in zip(sub, reqs):
        bad = differing_answer(a.result, b.result,
                               SUMMARY_KEYS + ("playouts", "rounds"))
        check(not bad, f"serve: request {a.rid} run to completion "
                       f"(one_per_core) differs from the main run in {bad}")
    again["one_per_core"] = served_arm(e3, sub, w3)

    tick = profile_one_tick(torch)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    sessions = serve_sessions(torch)
    chaos = serve_chaos(torch)
    by_class = {g: {"requests": sum(r.game == g and r.n_trees == 1
                                    for r in reqs),
                    "preemptions": sum(t.preemptions
                                       for t in eng.finished_tickets
                                       if t.req.game == g)}
                for g, _ in SERVE_GAMES}
    emit("serve_games", config={**SERVE_ENGINE, "requests": SERVE_REQUESTS,
                                "games": [list(g) for g in SERVE_GAMES],
                                "playouts": list(SERVE_PLAYOUTS),
                                "playouts_per_task": SERVE_GRAIN,
                                "forest": SERVE_FOREST},
         served_playouts=served_playouts,
         served_playouts_per_s=served_playouts / wall, seconds=wall,
         queue_wait_p50_s=stats.queue_wait_p50,
         queue_wait_p95_s=stats.queue_wait_p95,
         latency_p50_s=stats.latency_p50, latency_p95_s=stats.latency_p95,
         quanta=stats.quanta, preemptions=stats.n_preemptions,
         by_class=by_class, sync_iterations=sum(iters.values()),
         device_wait_s={"main_pipelined": stats.device_wait_s,
                        **{f"first{SERVE_BLOCKING}_{k}": v["device_wait_s"]
                           for k, v in again.items()}},
         first6=again, launches=launches, one_tick=tick,
         peak_memory_mb=peak_mb, equal_to_direct=direct,
         pipelined_equal_blocking=True, one_per_core_equal_fifo=True,
         sessions=sessions, chaos=chaos,
         phase_seconds=time.perf_counter() - t_phase)
    return launches, served_playouts / wall


def served_arm(eng, reqs, wall: float) -> dict:
    """Latency, throughput and host wait of one rerun of some requests."""
    st = eng.stats()
    return {"device_wait_s": st.device_wait_s, "seconds": wall,
            "playouts_per_s": sum(r.result["playouts"] for r in reqs) / wall,
            "latency_p50_s": st.latency_p50, "latency_p95_s": st.latency_p95,
            "quanta": st.quanta, "preemptions": st.n_preemptions}


def fresh_request(r):
    """A new request object with ``r``'s fields and no served state."""
    import dataclasses
    return dataclasses.replace(r, out=[], done=False, result=None)


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
    q32c, k32c, v32c = (t.float().contiguous() for t in (qh, kh, vh))
    lib32 = lambda: F.scaled_dot_product_attention(
        q32c, k32c, v32c, is_causal=True, enable_gqa=True)
    f32_ms, f32_lib = time_pair_ms(f32_call, lib32, iters=50)
    cuda_cores = {"dtype": "float32", "ms": f32_ms,
                  "in_graph_ms": graph_ms(f32_call, launches=10),
                  "plain_ms": time_ms(lambda: ref.flash_attention(
                      q32c, k32c, v32c, causal=True), iters=20, warmup=3),
                  "bound_ms": f32_bound, "bound_by": f32_by,
                  "library_ms": f32_lib,
                  "library_in_graph_ms": graph_ms(lib32, launches=10),
                  "library_max_abs_diff": float(
                      (lib32().transpose(1, 2) - f32_call()).abs().max())}
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

    def lm_kernels_train_shape() -> dict:
        """rmsnorm at the training shape (one microbatch, 1,024 x 576 bf16, the
        model's order): held against its plain version, timed eagerly (in
        turns with ``F.rms_norm``), in a CUDA graph and plain, beside its
        bound; then the forward and backward under autograd (the kernel, then
        the plain version's gradient) in turns with ``F.rms_norm``'s, and the
        backward alone."""
        import torch.nn.functional as F
        from repro_torch.kernels import ops, ref
        N, D = LM_TRAIN_NORM_SHAPE
        bf = torch.bfloat16
        x = (3 * torch.randn(N, D, generator=g, device="cuda")).to(bf)
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(bf)
        call = lambda: ops.rmsnorm(x, w, 1e-5, order="model")
        plain = lambda: ref.rmsnorm(x, w, 1e-5, order="model")
        lib = lambda: F.rms_norm(x, (D,), w, 1e-5)
        steps = int(bf16_steps(torch, call(), plain()).max())
        check(steps <= RMSNORM_BF16_STEPS["model"],
              f"rmsnorm at the training shape: {steps} bf16 steps from plain")
        ms, lib_ms = time_pair_ms(call, lib)
        bound, by = bound_ms(2 * (2 * N * D + D), 4 * N * D, OPS_PER_S)
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        cot = torch.randn(N, D, generator=g, device="cuda").to(bf)

        def fwd_bwd(f):
            return lambda: torch.autograd.grad(f(xg, wg), (xg, wg), cot)

        kernel_fb = fwd_bwd(lambda a, b: ops.rmsnorm(a, b, 1e-5, order="model"))
        lib_fb = fwd_bwd(lambda a, b: F.rms_norm(a, (D,), b, 1e-5))
        fb_ms, lib_fb_ms = time_pair_ms(kernel_fb, lib_fb, iters=50)
        out = ops.rmsnorm(xg, wg, 1e-5, order="model")
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, (xg, wg), cot,
                                                     retain_graph=True), iters=50)
        # the backward reads x, w and the cotangent and writes dx and dw: its
        # bound, as the forward's, is bytes
        bwd_bound, bwd_by = bound_ms(2 * (3 * N * D + 2 * D), 10 * N * D,
                                     OPS_PER_S)
        return {"shape": [N, D], "dtype": "bfloat16", "order": "model",
                "max_bf16_steps": steps, "ms": ms, "in_graph_ms": graph_ms(call),
                "plain_ms": time_ms(plain), "bound_ms": bound, "bound_by": by,
                "library_ms": lib_ms, "library_in_graph_ms": graph_ms(lib),
                "forward_backward_ms": fb_ms,
                "library_forward_backward_ms": lib_fb_ms,
                "backward_ms": bwd_ms, "backward_bound_ms": bwd_bound,
                "backward_bound_by": bwd_by,
                "backward": "the plain version's gradient (kernels._autograd)"}

    rn_train = lm_kernels_train_shape()

    def lm_kernels_flash_train_shape() -> dict:
        """flash attention at the training shape (one microbatch: 4 x 256
        tokens, 9 heads over 3, d 64, bf16, bshd) under autograd: the
        forward (the kernel) and forward + backward (the plain version's
        gradient, ``kernels._autograd``) each in turns with the library
        call's on contiguous (B, H, S, d) copies, the plain version's
        forward + backward, and the backward alone, beside their bounds."""
        import torch.nn.functional as F
        from repro_torch.kernels import ops, ref
        B, H, Hkv, S, d = LM_TRAIN_FLASH_SHAPE
        bf = torch.bfloat16
        q, k, v = (torch.randn(B, S, n, d, generator=g, device="cuda").to(bf)
                   .requires_grad_(True) for n in (H, Hkv, Hkv))
        cot = torch.randn(B, S, H, d, generator=g, device="cuda").to(bf)
        qc, kc, vc = (t.detach().transpose(1, 2).contiguous()
                      .requires_grad_(True) for t in (q, k, v))
        cot_c = cot.transpose(1, 2).contiguous()
        call = lambda a, b, c: ops.flash_attention(a, b, c, causal=True)
        lib = lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True)
        with torch.no_grad():
            ms, lib_ms = time_pair_ms(lambda: call(q, k, v), lib)
        plain = lambda: ref.flash_attention(*(t.transpose(1, 2)
                                              for t in (q, k, v)), causal=True)
        fb = lambda: torch.autograd.grad(call(q, k, v), (q, k, v), cot)
        lib_fb = lambda: torch.autograd.grad(lib(), (qc, kc, vc), cot_c)
        fb_ms, lib_fb_ms = time_pair_ms(fb, lib_fb, iters=50)
        plain_fb_ms = time_ms(lambda: torch.autograd.grad(
            plain(), (q, k, v), cot_c), iters=50)
        out = call(q, k, v)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, (q, k, v), cot, retain_graph=True), iters=50)
        rows, kv_rows = B * H * S * d, B * Hkv * S * d
        pairs = B * H * (S * (S + 1) // 2) * d
        # forward: q, k, v read, o written, the causal pairs' two products;
        # backward: q, k, v, o and dO read, dq, dk, dv written, five
        # products (the scores again, dP, dV, dQ, dK)
        fwd_bytes, bwd_bytes = 2 * (2 * rows + 2 * kv_rows), \
            2 * (4 * rows + 4 * kv_rows)
        bound, by = bound_ms(fwd_bytes, 4 * pairs, BF16_TENSOR_OPS_PER_S)
        fb_bound, fb_by = bound_ms(fwd_bytes + bwd_bytes, 14 * pairs,
                                   BF16_TENSOR_OPS_PER_S)
        return {"shape": [B, H, Hkv, S, d], "dtype": "bfloat16",
                "layout": "bshd", "ms": ms, "library_ms": lib_ms,
                "bound_ms": bound, "bound_by": by,
                "forward_backward_ms": fb_ms,
                "library_forward_backward_ms": lib_fb_ms,
                "plain_forward_backward_ms": plain_fb_ms,
                "forward_backward_bound_ms": fb_bound,
                "forward_backward_bound_by": fb_by, "backward_ms": bwd_ms,
                "backward": "the plain version's gradient (kernels._autograd)"}

    fa_train = lm_kernels_flash_train_shape()

    def lm_kernels_roofline_shapes() -> dict:
        """rmsnorm and flash attention at the shapes the lm_roofline cells
        give them (``roofline_kernel_shapes``), each held against its plain
        version there and timed (in turns with the library call; the
        iterations scaled down with the work) beside its bound. Flash at
        32,768 tokens is held against the plain version on a slice of its
        heads (ROOFLINE_FLASH_PLAIN_BYTES); its plain time is that
        slice's."""
        import torch.nn.functional as F
        from repro_torch.kernels import flash_attention as fa, ops, ref
        bf = torch.bfloat16
        norms, flashes = roofline_kernel_shapes()
        out = {"rmsnorm": [], "flash_attention": []}
        for N, D, of in norms:
            x = (3 * torch.randn(N, D, generator=g, device="cuda")).to(bf)
            w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(bf)
            call = lambda: ops.rmsnorm(x, w, 1e-5, order="model")
            plain = lambda: ref.rmsnorm(x, w, 1e-5, order="model")
            lib = lambda: F.rms_norm(x, (D,), w, 1e-5)
            apart = bf16_steps(torch, call(), plain())
            share, steps = float((apart > 0).float().mean()), int(apart.max())
            check(share <= RMSNORM_BF16_SHARE
                  and steps <= RMSNORM_BF16_STEPS["model"],
                  f"rmsnorm at ({N}, {D}): {share:.4%} of elements differ, "
                  f"up to {steps} bf16 steps")
            ms, lib_ms = time_pair_ms(call, lib, iters=50, warmup=5, pairs=4)
            bound, by = bound_ms(2 * (2 * N * D + D), 4 * N * D, OPS_PER_S)
            out["rmsnorm"].append({
                "shape": [N, D], "of": of, "dtype": "bfloat16",
                "order": "model", "share_differing": share,
                "max_bf16_steps": steps, "ms": ms,
                "plain_ms": time_ms(plain, iters=10, warmup=2, reps=3),
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
        for (B, H, Hkv, S, d), of in flashes:
            q, k, v = (torch.randn(B, S, n, d, generator=g, device="cuda")
                       .to(bf) for n in (H, Hkv, Hkv))
            body = fa.body_for(q.dtype, d)
            call = lambda: ops.flash_attention(q, k, v, causal=True)
            before = dict(fa.flash_attention.launches_by_body)
            got = call()
            check(fa.flash_attention.launches_by_body[body] == before[body] + 1,
                  f"flash_attention at {(B, H, Hkv, S, d)}: not the {body} body")
            G = H // Hkv
            kvh = (Hkv if B * H * S * S * 4 <= ROOFLINE_FLASH_PLAIN_BYTES
                   else ROOFLINE_FLASH_PLAIN_HEADS)
            qh, kh, vh = (t[:, :, :n].transpose(1, 2)
                          for t, n in ((q, kvh * G), (k, kvh), (v, kvh)))
            plain = lambda: ref.flash_attention(qh, kh, vh, causal=True)
            err = float((got[:, :, :kvh * G].float()
                         - plain().transpose(1, 2).float()).abs().max())
            check(err <= FLASH_TOL["bfloat16"],
                  f"flash_attention at {(B, H, Hkv, S, d)}: max abs err {err} "
                  f"above {FLASH_TOL['bfloat16']}")
            del got
            qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, enable_gqa=True)
            iters = max(2, 20 * 4096 ** 2 // S ** 2)
            ms, lib_ms = time_pair_ms(call, lib, iters=iters, warmup=2,
                                      pairs=4)
            n_bytes = 2 * (2 * B * H * S * d + 2 * B * Hkv * S * d)
            n_ops = 4 * B * H * (S * (S + 1) // 2) * d
            bound, by = bound_ms(n_bytes, n_ops, BF16_TENSOR_OPS_PER_S)
            out["flash_attention"].append({
                "shape": [B, H, Hkv, S, d], "of": of, "dtype": "bfloat16",
                "layout": "bshd", "body": body, "max_abs_err": err,
                "plain_heads": kvh * G, "ms": ms,
                "plain_ms": time_ms(plain, iters=2, warmup=1, reps=3),
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
            del q, k, v, qc, kc, vc
        torch.cuda.empty_cache()
        return out

    roofline_shapes = lm_kernels_roofline_shapes()

    def lm_kernels_new_shapes() -> dict:
        """The LM kernels at the shapes LM serving gives them, each held
        against its plain version there and timed eagerly, in a CUDA graph
        and plain, beside its bound and (in turns) the library call: flash
        attention at the batched search's prefill (4 x 64 = 256 rows, 9
        heads over 3, 128 tokens, d 64, bf16, bshd), rmsnorm at the slot
        engines' decode rows (8 x 576) and the batched search's (256 x
        576), bf16, the model's order, and the one-tile uct_select at the
        forest's descent tile (4 x 64 = 256 lanes, C = 8)."""
        import torch.nn.functional as F
        from repro_torch.kernels import flash_attention as fa, ops, ref
        from repro_torch.kernels import uct_select as us
        g = torch.Generator(device="cuda").manual_seed(3)
        bf = torch.bfloat16
        out = {"flash_attention": [], "rmsnorm": [], "uct_select": []}

        B, H, Hkv, S, d = len(LM_BATCH_LENS) * LM_SEARCH["n_workers"], 9, 3, \
            LM_PROMPT_LEN, 64
        q = torch.randn(B, S, H, d, generator=g, device="cuda").to(bf)
        k = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(bf)
        v = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(bf)
        call = lambda: ops.flash_attention(q, k, v, causal=True)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        plain = lambda: ref.flash_attention(qh, kh, vh, causal=True)
        err = float((call().float()
                     - plain().transpose(1, 2).float()).abs().max())
        check(err <= FLASH_TOL["bfloat16"],
              f"flash_attention at {(B, H, Hkv, S, d)}: max abs err {err}")
        qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
        lib = lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True)
        ms, lib_ms = time_pair_ms(call, lib)
        n_bytes = 2 * (2 * B * H * S * d + 2 * B * Hkv * S * d)
        n_ops = 4 * B * H * (S * (S + 1) // 2) * d
        bound, by = bound_ms(n_bytes, n_ops, BF16_TENSOR_OPS_PER_S)
        out["flash_attention"].append({
            "shape": [B, H, Hkv, S, d], "dtype": "bfloat16", "layout": "bshd",
            "body": fa.body_for(q.dtype, d), "max_abs_err": err, "ms": ms,
            "in_graph_ms": graph_ms(call), "plain_ms": time_ms(plain, iters=10,
                                                               warmup=2),
            "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
            "library_ms": lib_ms, "library_in_graph_ms": graph_ms(lib)})

        D = 576
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(bf)
        for N in (LM_SERVE_ENGINE["n_slots"], B):
            x = torch.randn(N, 1, D, generator=g, device="cuda").to(bf)
            call = lambda: ops.rmsnorm(x, w, 1e-5, order="model")
            plain = lambda: ref.rmsnorm(x, w, 1e-5, order="model")
            lib = lambda: F.rms_norm(x, (D,), w, 1e-5)
            err = float((call().float() - plain().float()).abs().max())
            steps = int(bf16_steps(torch, call(), plain()).max())
            check(steps <= RMSNORM_BF16_STEPS["model"],
                  f"rmsnorm at ({N}, {D}): {steps} bf16 steps from plain")
            ms, lib_ms = time_pair_ms(call, lib)
            bound, by = bound_ms(2 * (2 * N * D + D), 4 * N * D, OPS_PER_S)
            out["rmsnorm"].append({
                "shape": [N, 1, D], "dtype": "bfloat16", "order": "model",
                "max_abs_err": err, "max_bf16_steps": steps, "ms": ms,
                "in_graph_ms": graph_ms(call), "plain_ms": time_ms(plain),
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "library_in_graph_ms": graph_ms(lib)})

        W, C = B, LM_SEARCH["branch"]
        args, nz, lm = uct_case(torch, W, C, True, True, seed=11)
        call = lambda: us.uct_select(*args, 1.0, noise=nz, lane_mask=lm)
        plain = lambda: ref.uct_select(*args, 1.0, noise=nz, lane_mask=lm)
        check(torch.equal(call(), plain()),
              f"uct_select at ({W}, {C}): picks differ from the plain version")
        n_bytes = 4 * W * C * 4 + W * C + W * 4 + W + W * 4
        bound, by = bound_ms(n_bytes, UCT_OPS * W * C, OPS_PER_S)
        out["uct_select"].append({
            "shape": [W, C], "max_abs_err": 0, "ms": time_ms(call),
            "in_graph_ms": graph_ms(call),
            "plain_ms": time_ms(plain, iters=50),
            "bound_ms": bound, "bound_by": by, "library_ms": None})
        return out

    def kernels_at_shapes(norm_shapes, flash_shapes, seed: int) -> dict:
        """rmsnorm and flash attention at the shapes a path gives them, each
        held against its plain version there (and its difference from the
        library call recorded) and timed eagerly (in turns with the library
        call), in a CUDA graph and plain, beside its bound: rmsnorm (bf16, the
        model's order) at each of ``norm_shapes`` ((D, which norm, the row
        counts the path gives it)); flash attention (bf16, bshd) at each
        of ``flash_shapes`` (((B, H, Hkv, S, d), whose)), on the body
        ``body_for`` names."""
        import torch.nn.functional as F
        from repro_torch.kernels import flash_attention as fa, ops, ref
        g = torch.Generator(device="cuda").manual_seed(seed)
        bf = torch.bfloat16
        out = {"rmsnorm": [], "flash_attention": []}
        for D, where, norm_rows in norm_shapes:
            w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(bf)
            for N in norm_rows:
                x = (3 * torch.randn(N, 1, D, generator=g, device="cuda")).to(bf)
                call = lambda: ops.rmsnorm(x, w, 1e-5, order="model")
                plain = lambda: ref.rmsnorm(x, w, 1e-5, order="model")
                lib = lambda: F.rms_norm(x, (D,), w, 1e-5)
                got, want = call(), plain()
                apart = bf16_steps(torch, got, want)
                share = float((apart > 0).float().mean())
                steps = int(apart.max())
                check(share <= RMSNORM_BF16_SHARE
                      and steps <= RMSNORM_BF16_STEPS["model"],
                      f"rmsnorm at ({N}, {D}): {share:.4%} of elements differ, "
                      f"up to {steps} bf16 steps")
                ms, lib_ms = time_pair_ms(call, lib)
                bound, by = bound_ms(2 * (2 * N * D + D), 4 * N * D, OPS_PER_S)
                out["rmsnorm"].append({
                    "shape": [N, 1, D], "width_of": where, "dtype": "bfloat16",
                    "order": "model",
                    "max_abs_err": float((got.float() - want.float()).abs().max()),
                    "library_max_abs_diff": float(
                        (got.float() - lib().float()).abs().max()),
                    "share_differing": share, "max_bf16_steps": steps, "ms": ms,
                    "in_graph_ms": graph_ms(call), "plain_ms": time_ms(plain),
                    "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                    "library_in_graph_ms": graph_ms(lib)})
        for (B, H, Hkv, S, d), where in flash_shapes:
            q = torch.randn(B, S, H, d, generator=g, device="cuda").to(bf)
            k = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(bf)
            v = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(bf)
            body = fa.body_for(q.dtype, d)
            call = lambda: ops.flash_attention(q, k, v, causal=True)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            plain = lambda: ref.flash_attention(qh, kh, vh, causal=True)
            before = dict(fa.flash_attention.launches_by_body)
            got = call()
            check(fa.flash_attention.launches_by_body[body] == before[body] + 1,
                  f"flash_attention at {(B, H, Hkv, S, d)}: not the {body} body")
            err = float((got.float() - plain().transpose(1, 2).float()).abs().max())
            check(err <= FLASH_TOL["bfloat16"],
                  f"flash_attention at {(B, H, Hkv, S, d)}: max abs err {err} "
                  f"above {FLASH_TOL['bfloat16']}")
            qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
            lib = lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, enable_gqa=True)
            ms, lib_ms = time_pair_ms(call, lib)
            n_bytes = 2 * (2 * B * H * S * d + 2 * B * Hkv * S * d)
            n_ops = 4 * B * H * (S * (S + 1) // 2) * d
            # the tensor-core body's products are bf16 on the tensor cores, the
            # CUDA-core body's float32 on the CUDA cores
            bound, by = bound_ms(n_bytes, n_ops, BF16_TENSOR_OPS_PER_S
                                 if body == "tensor_cores" else OPS_PER_S)
            out["flash_attention"].append({
                "shape": [B, H, Hkv, S, d], "of": where, "dtype": "bfloat16",
                "layout": "bshd", "body": body, "max_abs_err": err,
                "library_max_abs_diff": float(
                    (got.float() - lib().transpose(1, 2).float()).abs().max()),
                "ms": ms,
                "in_graph_ms": graph_ms(call),
                "plain_ms": time_ms(plain, iters=10, warmup=2),
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "library_in_graph_ms": graph_ms(lib)})
        return out

    new_shapes = lm_kernels_new_shapes()
    families_shapes = kernels_at_shapes(
        [(D, where, FAMILY_NORM_ROWS) for D, where in FAMILY_NORM_WIDTHS],
        FAMILY_FLASH_SHAPES, seed=9)
    ve_shapes = kernels_at_shapes(VE_NORM_SHAPES, (VE_FLASH_SHAPE,), seed=10)
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
         "bodies": {"tensor_cores": tensor_cores, "cuda_cores": cuda_cores},
         "new_shapes": new_shapes["flash_attention"],
         "families_shapes": families_shapes["flash_attention"],
         "vlm_encdec_shapes": ve_shapes["flash_attention"],
         "train_shape": fa_train,
         "roofline_shapes": roofline_shapes["flash_attention"]},
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
         "prefill_library_in_graph_ms": rn_prefill_lib_graph,
         "train_shape": rn_train,
         "new_shapes": new_shapes["rmsnorm"],
         "families_shapes": families_shapes["rmsnorm"],
         "vlm_encdec_shapes": ve_shapes["rmsnorm"],
         "roofline_shapes": roofline_shapes["rmsnorm"]},
    ]
    emit("lm_kernels", flash_attention=flash, rmsnorm=norm,
         timed={r["name"]: {k: r[k] for k in (
             "ms", "in_graph_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "library_in_graph_ms")}
                for r in records},
         flash_bodies=records[0]["bodies"], rmsnorm_host_us=rn_host,
         rmsnorm_prefill={k: records[1][k] for k in (
             "prefill_shape", "prefill_in_graph_ms", "prefill_bound_ms",
             "prefill_library_in_graph_ms")}, rmsnorm_train_shape=rn_train,
         flash_train_shape=fa_train,
         new_shapes=new_shapes, families_shapes=families_shapes,
         vlm_encdec_shapes=ve_shapes, roofline_shapes=roofline_shapes)
    return records, new_shapes["uct_select"]


# --------------------------------------------------------------- LM search ----
def lm_model(torch):
    """SmolLM-135M at its published width (30 layers, d=576, 9 heads over 3
    KV heads, vocab 49,152, bf16, flash prefill), random weights from seed
    0: (config, params, seconds it took). ``main`` builds it once and hands
    it to every LM phase."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    mcfg = get_config("smollm-135m").replace(use_flash=True)
    t0 = time.perf_counter()
    params = api.init_params(mcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    return mcfg, params, time.perf_counter() - t0


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


def phase_lm_search(torch, model=None):
    """SmolLM-135M at its published width (30 layers, d=576, 9 heads over 3
    KV heads, vocab 49,152, bf16, flash prefill), random weights from seed
    0: `mcts_generate` of LM_TOKENS tokens after a 128-token prompt, run
    twice (tokens and every search's tree bit-identical), with launch
    counters, invariants, timings, a profiled iteration, and the decoding
    held against the plain versions (`check_decode_steps`,
    `check_decode_vs_plain`)."""
    from repro_torch import parity, rng
    from repro_torch.core.tree import check_invariants
    from repro_torch.models import api
    from repro_torch.serve.mcts_decode import MCTSDecodeConfig, mcts_generate
    mcfg, params, init_s = model or lm_model(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, mcfg.vocab, (LM_PROMPT_LEN,), generator=g,
                           device="cuda", dtype=torch.int32)
    n_tokens, n_playouts = LM_TOKENS, LM_PLAYOUTS
    dcfg = MCTSDecodeConfig(**{**LM_SEARCH, "n_playouts": n_playouts})
    key = rng.key(0, "cuda")

    # warm the allocator, cuBLAS and the kernels on a short search
    mcts_generate(params, mcfg, prompt, 1,
                  MCTSDecodeConfig(**{**LM_SEARCH, "n_playouts": 64}), key)

    counters = zero_lm_counters()   # the LM path's counts: zeroed just before
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks_a, st_a = mcts_generate(params, mcfg, prompt, n_tokens, dcfg, key,
                                 keep_trees=True)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches, flash_by_body = read_lm_counters(counters)
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


# ---------------------------------------------------------------- LM serving ----
def zero_lm_counters():
    """Zero the LM path's kernel counters (and flash's per-body counts)
    just before a path runs; returns the counters."""
    from repro_torch.kernels import flash_attention as fa
    counters = lm_path_counters()
    for c in counters.values():
        c.launches = 0
    fa.flash_attention.launches_by_body = dict.fromkeys(fa.BODIES, 0)
    return counters


def read_lm_counters(counters):
    from repro_torch.kernels import flash_attention as fa
    return ({name: c.launches for name, c in counters.items()},
            dict(fa.flash_attention.launches_by_body))


def add_counts(*dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def lm_batch_inputs(torch, vocab):
    """The lm_batch prompts: a (4, 128) matrix of seeded tokens, each row
    left-aligned at its true length (LM_BATCH_LENS) with 0 after it, as
    host arrays."""
    import numpy as np
    g = torch.Generator(device="cuda").manual_seed(2)
    B, P = len(LM_BATCH_LENS), max(LM_BATCH_LENS)
    prompts = torch.randint(1, vocab, (B, P), generator=g, device="cuda",
                            dtype=torch.int32).cpu().numpy()
    lens = np.asarray(LM_BATCH_LENS, np.int32)
    prompts[np.arange(P)[None, :] >= lens[:, None]] = 0
    return prompts, lens


def lm_batch_cfg(n_playouts: int = LM_BATCH_PLAYOUTS):
    from repro_torch.serve.mcts_decode import MCTSDecodeConfig
    return MCTSDecodeConfig(**{**LM_SEARCH, "n_playouts": n_playouts})


def profile_one_batch_iteration(torch, params, mcfg, dcfg, prompts, lens,
                                key):
    """CUDA kernels, device ms and wall ms of ONE sync iteration of the
    batched search (after three, so it descends real trees), by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import rng
    from repro_torch.core.gscpm import fold_task_keys
    from repro_torch.core.root_parallel import fold_member_task_keys
    from repro_torch.core.tree import init_forest
    from repro_torch.serve import mcts_decode as md
    B, P = prompts.shape
    W = dcfg.n_workers
    dev = torch.device("cuda")
    p = torch.as_tensor(prompts, device=dev)
    lens_t = torch.as_tensor(lens, device=dev)
    root, cache = md.prefill_batch(params, mcfg, p, lens_t, W,
                                   P + dcfg.max_depth + dcfg.rollout_len + 1)
    forest = init_forest(B, dcfg.tree_cap, dcfg.branch, 1, device=dev)
    keys = fold_member_task_keys(
        fold_task_keys(key, torch.arange(B, dtype=torch.int32, device=dev)),
        torch.arange(W, dtype=torch.int32, device=dev))
    active = torch.ones((B, W), dtype=torch.bool, device=dev)
    step = lambda i: md._iteration(forest, params, mcfg, dcfg, cache, root,
                                   lens_t, dcfg.cp, rng.fold_in(keys, i),
                                   active)
    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(3)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, device_ms = cuda_activity(prof)
    check(device_ms, "torch.profiler saw no CUDA kernel in a batched "
                     "LM iteration")
    return {"cuda_kernels": kernels, "device_ms": device_ms,
            "wall_ms_profiled": wall_ms}


def check_batch_vs_plain(torch, params, mcfg, dcfg, prompts, lens, key, buf):
    """The batched decoding, kernels vs plain versions on the same card, as
    ``check_decode_vs_plain`` holds the single search: the generation again
    inside ``ops.plain_versions()``, then the first search whose committed
    tokens differ (else the first) stepped both ways, member by member
    (``parity.step_decode_search_batch``)."""
    import numpy as np
    from repro_torch import parity, rng
    from repro_torch.kernels import ops
    from repro_torch.serve import mcts_decode as md
    B, P = prompts.shape
    T = buf.shape[1] - P
    with ops.plain_versions():
        plain, _, _ = md.mcts_generate_batch(params, mcfg, prompts, lens, T,
                                             dcfg, key)
    rows = np.arange(B)
    step_tokens = lambda m: [m[rows, lens + i].tolist() for i in range(T)]
    ours, theirs = step_tokens(buf), step_tokens(plain)
    differ = [i for i in range(T) if ours[i] != theirs[i]]
    i = differ[0] if differ else 0
    matrix = np.zeros_like(buf)
    matrix[:, :P] = prompts
    for j in range(i):
        matrix[rows, lens + j] = ours[j]
    rep = parity.step_decode_search_batch(
        params, mcfg, dcfg, torch.as_tensor(matrix), rng.fold_in(key, i),
        ops.plain_versions, prompt_lens=lens + i)
    scale = rep["max_abs_logit"]
    for name in ("root_err", "leaf_err", "rollout_err"):
        check(rep[name] <= LOGITS_TOL * scale,
              f"LM batch {name}: kernels vs plain max abs err {rep[name]} "
              f"above {LOGITS_TOL} x {scale}")
    check(not rep["unexcused"],
          "LM batch: kernels and plain versions part at decisions their "
          f"measured error does not explain: {rep['unexcused'][:3]}")
    check(rep["best_tokens"] == [ours[i], theirs[i]],
          f"batch search {i} stepped ends on {rep['best_tokens']}, "
          f"mcts_generate_batch committed {[ours[i], theirs[i]]}")
    check(not differ or rep["parted_at"] is not None,
          f"committed tokens of search {i} differ, yet the stepped search "
          "never parted")
    return {"tokens_kernels": ours, "tokens_plain": theirs,
            "tokens_equal": not differ, "stepped_search": i,
            "tolerance": f"logits {LOGITS_TOL} x max |logit|; a parting "
                         "decision's margins within 2 x the measured "
                         "difference of its numbers",
            **{k: v for k, v in rep.items() if k != "unexcused"}}


def batch_vs_singles(torch, params, mcfg, dcfg, prompts, lens, key):
    """One token for the 4 prompts as ONE batched search against 4
    single-request searches at the same budget, timed in turns (batch,
    singles, singles, batch): seconds of each, and the batch's time per
    token over theirs."""
    from repro_torch import rng
    from repro_torch.serve import mcts_decode as md
    B = prompts.shape[0]

    def batch():
        md.mcts_decode_search_batch(params, mcfg, prompts, dcfg, key,
                                    prompt_lens=lens)

    def singles():
        for b in range(B):
            md.mcts_decode_search(params, mcfg,
                                  torch.as_tensor(prompts[b, :lens[b]]),
                                  dcfg, rng.fold_in(key, b))

    runs = {"batch": [], "singles": []}
    for name, fn in (("batch", batch), ("singles", singles),
                     ("singles", singles), ("batch", batch)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs[name].append(time.perf_counter() - t0)
    tb, ts = (sum(runs[k]) / len(runs[k]) for k in ("batch", "singles"))
    return {"batch_s": runs["batch"], "singles_s": runs["singles"],
            "batch_ms_per_token": 1e3 * tb / B,
            "singles_ms_per_token": 1e3 * ts / B,
            "batch_over_singles": tb / ts}


def phase_lm_batch(torch, model=None):
    """B = 4 token trees searched as one forest (``mcts_generate_batch``)
    on SmolLM-135M at its published width: 1 token for 4 prompts of true
    lengths 128, 112, 96 and 128 in one (4, 128) matrix, W = 64,
    LM_BATCH_PLAYOUTS a token. Checks: root visits == LM_BATCH_PLAYOUTS on
    every member, the forest's invariants, a masked member left at one
    node with best token -1, the generation run twice bit-identical,
    kernels against plain
    versions over the whole batched search, one ``uct_select`` launch a
    descent level for all B·W lanes, one flash prefill (30 launches) a
    search."""
    import numpy as np
    from repro_torch import parity, rng
    from repro_torch.core.root_parallel import check_forest_invariants
    from repro_torch.serve import mcts_decode as md
    t_phase = time.perf_counter()
    mcfg, params, _ = model or lm_model(torch)
    prompts, lens = lm_batch_inputs(torch, mcfg.vocab)
    B, P = prompts.shape
    T, L = LM_BATCH_TOKENS, mcfg.n_layers
    dcfg = lm_batch_cfg()
    key = rng.key(1, "cuda")
    # warm the allocator at the batch's shapes
    md.mcts_decode_search_batch(params, mcfg, prompts, lm_batch_cfg(64), key,
                                prompt_lens=lens)

    counters = zero_lm_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf, new_lens, st_a = md.mcts_generate_batch(params, mcfg, prompts, lens,
                                                 T, dcfg, key, keep_trees=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, flash_by_body = read_lm_counters(counters)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    # the same generation again: bit-identical, and the descent levels it
    # takes (the deepest lane's depth + 1 a selection), read on the side
    levels = []
    orig = md.select_token_batch

    def recording(tree, cfg, cp, keys):
        out = orig(tree, cfg, cp, keys)
        levels.append(int(out[1].max()) + 1)
        return out

    before = counters["uct_select"].launches
    md.select_token_batch = recording
    try:
        buf_b, _, st_b = md.mcts_generate_batch(params, mcfg, prompts, lens,
                                                T, dcfg, key, keep_trees=True)
    finally:
        md.select_token_batch = orig
    uct_b = counters["uct_select"].launches - before
    check(np.array_equal(buf, buf_b), "LM batch: tokens differ run to run")
    for a, b in zip(st_a, st_b):
        fields = parity.differing_fields(a["forest"], b["forest"])
        check(fields == [], f"LM batch: forests differ run to run in {fields}")
    iters = sum(s["sync_iterations"] for s in st_a)
    check(uct_b == sum(levels) == launches["uct_select"],
          f"uct_select launches {launches['uct_select']} (rerun {uct_b}) != "
          f"descent levels {sum(levels)} over {iters} iterations: one "
          "(B·W, C) tile a level for the whole forest")
    check(launches["flash_attention"] == T * L
          and flash_by_body == {"tensor_cores": T * L, "cuda_cores": 0},
          f"flash_attention launches {flash_by_body} != {T} prefills of "
          f"{B}x{dcfg.n_workers} rows x {L} layers, all tensor-core")
    steps = iters * (dcfg.max_depth + dcfg.rollout_len) + T   # + root decodes
    check(launches["rmsnorm"] == (2 * L + 1) * (T + steps),
          f"rmsnorm launches {launches['rmsnorm']} != 61 x (prefills + "
          "decode steps)")
    for i, s in enumerate(st_a):
        f = s["forest"]
        check(bool((f.visits[:, 0] == LM_BATCH_PLAYOUTS).all()),
              f"LM batch: root visits {f.visits[:, 0].tolist()} != "
              f"{LM_BATCH_PLAYOUTS}")
        check_forest_invariants(f, discrete_credits=False)
        check(bool(torch.isfinite(f.wins).all()), "LM batch: non-finite wins")
        check(s["best_tokens"] == buf[np.arange(B), lens + i].tolist(),
              "LM batch: committed tokens are not the best root children")
    new = buf[np.arange(B)[:, None], lens[:, None] + np.arange(T)[None, :]]
    check(bool(((new >= 0) & (new < mcfg.vocab)).all()),
          f"LM batch: generated tokens out of range: {new.tolist()}")
    check(new_lens.tolist() == (lens + T).tolist(), "LM batch: lengths")

    # a masked member stays a one-node tree with best token -1
    fm, sm = md.mcts_decode_search_batch(params, mcfg, prompts, dcfg, key,
                                         prompt_lens=lens,
                                         request_mask=LM_BATCH_MASK)
    dead = LM_BATCH_MASK.index(False)
    check(sm["tree_nodes"][dead] == 1 and sm["best_tokens"][dead] == -1
          and float(fm.visits[dead].abs().sum()) == 0.0,
          f"LM batch: masked member searched: {sm['tree_nodes']}, "
          f"{sm['best_tokens']}")
    live = [b for b, m in enumerate(LM_BATCH_MASK) if m]
    check(bool((fm.visits[live, 0] == LM_BATCH_PLAYOUTS).all()),
          "LM batch: an active member's root visits with a masked member")

    vs_plain = check_batch_vs_plain(torch, params, mcfg, dcfg, prompts, lens,
                                    key, buf)
    prof = profile_one_batch_iteration(torch, params, mcfg, dcfg, prompts,
                                       lens, key)
    turns = batch_vs_singles(torch, params, mcfg, dcfg, prompts, lens, key)
    search_s = sum(s["time_s"] for s in st_a)
    ms_iter = 1e3 * search_s / iters
    emit("lm_batch",
         config={"model": "smollm-135m", "use_flash": True,
                 "prompt_lens": list(LM_BATCH_LENS), "matrix": [B, P],
                 "n_tokens": T, **LM_SEARCH, "n_playouts": LM_BATCH_PLAYOUTS,
                 "weights": "random, seed 0"},
         tokens=new.tolist(), run_twice_bit_identical=True,
         seconds_generate=wall, tokens_per_s=B * T / wall,
         seconds_search=search_s, sync_iterations=iters,
         ms_per_sync_iteration=ms_iter,
         prefill_ms=[1e3 * s["prefill_s"] for s in st_a],
         tree_nodes=[s["tree_nodes"] for s in st_a],
         launches=launches, flash_attention_launches_by_body=flash_by_body,
         descent_levels=sum(levels),
         backup_lane_steps_per_iteration=dcfg.n_workers,
         masked_member={"tree_nodes": sm["tree_nodes"],
                        "best_tokens": sm["best_tokens"]},
         one_iteration={**prof, "device_idle_share":
                        1 - prof["device_ms"] / prof["wall_ms_profiled"],
                        "unprofiled_ms_per_sync_iteration": ms_iter},
         peak_memory_mb=peak_mb, batch_vs_singles_in_turns=turns,
         kernels_vs_plain=vs_plain,
         phase_seconds=time.perf_counter() - t_phase)
    return launches, flash_by_body


def lm_serve_trace(vocab):
    from benchmarks_torch.tpfifo import make_trace
    t = LM_SERVE_TRACE
    return make_trace(t["n_requests"], t["rate_rps"], t["max_new"],
                      t["short_lens"], t["long_lens"], vocab, t["seed"])


def profile_one_step(torch, eng, reqs, warm_ticks: int = 2):
    """CUDA kernels, device ms and wall ms of one engine tick, after
    ``warm_ticks`` ticks on ``reqs`` (the engine is then drained)."""
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=warm_ticks, on_exhaust="ignore")
    torch.cuda.synchronize()
    # CUDA activity only: the host's side of the tick is its wall clock,
    # and recording every host op of a ~120,000-kernel tick took a minute
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(max_ticks=1, on_exhaust="ignore")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    eng.run()
    kernels, device_ms = cuda_activity(prof)
    check(device_ms, "torch.profiler saw no CUDA kernel in a serving tick")
    return {"cuda_kernels": kernels, "device_ms": device_ms,
            "wall_ms": wall_ms, "device_idle_share": 1 - device_ms / wall_ms}


def served_stats(eng, wall: float) -> dict:
    st = eng.stats()
    return {"tokens_per_s": st.tokens / wall, "tokens": st.tokens,
            "seconds": wall, "queue_wait_p50_s": st.queue_wait_p50,
            "queue_wait_p95_s": st.queue_wait_p95,
            "latency_p50_s": st.latency_p50, "latency_p95_s": st.latency_p95,
            "quanta": st.quanta, "preemptions": st.n_preemptions,
            "ticks": eng._ticks, "device_wait_s": st.device_wait_s}


def phase_lm_serve(torch, model=None):
    """Greedy LM serving at full width on a Poisson trace of 16 requests
    (``benchmarks_torch.tpfifo.make_trace``): the TPFIFO engine (8 slots,
    max_len 256, grain 8), then the lockstep ``SlotEngine`` on the same
    trace. Checks: every request ends with 16 tokens; grain 4 and
    preemption after every quantum give the TPFIFO tokens bit for bit; no
    kernel build during the run; flash never on the TPFIFO engine (its
    prefill is chunked through decode), 30 launches an admission on
    ``SlotEngine``. Reports each engine's peak memory over its timed run
    and one profiled tick."""
    from benchmarks_torch.tpfifo import requests
    from repro_torch.kernels import _build
    from repro_torch.serve.engine import SlotEngine
    from repro_torch.serve.tpfifo import TPFIFOEngine
    t_phase = time.perf_counter()
    mcfg, params, _ = model or lm_model(torch)
    L = mcfg.n_layers
    trace = lm_serve_trace(mcfg.vocab)
    n_req, max_new = LM_SERVE_TRACE["n_requests"], LM_SERVE_TRACE["max_new"]
    tpfifo = lambda **kw: TPFIFOEngine(
        params, mcfg, **LM_SERVE_ENGINE, **{"grain": LM_SERVE_GRAIN, **kw},
        eos_id=-1, device="cuda")
    lockstep = lambda: SlotEngine(params, mcfg, **LM_SERVE_ENGINE, eos_id=-1,
                                  device="cuda")
    # warm: the first three requests through both engines
    for eng in (tpfifo(), lockstep()):
        eng.run_trace([(0.0, r) for _, r in requests(trace[:3])])

    def served(eng, what):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_trace(requests(trace))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_mb[what] = torch.cuda.max_memory_allocated() / 2**20
        got = {r.rid: list(r.out) for r in eng.finished}
        check(len(got) == n_req and all(len(o) == max_new
                                        for o in got.values()),
              f"{what}: {len(got)} requests, token counts "
              f"{sorted({len(o) for o in got.values()})}")
        check(all(0 <= t < mcfg.vocab for o in got.values() for t in o),
              f"{what}: a token outside the vocabulary")
        return got, wall

    peak_mb = {}
    builds = _build.builds
    counters = zero_lm_counters()
    eng = tpfifo()
    tp_out, tp_wall = served(eng, "TPFIFO")
    tp_launches, tp_bodies = read_lm_counters(counters)
    tp_stats = {**served_stats(eng, tp_wall),
                "peak_memory_mb": peak_mb["TPFIFO"]}
    check(_build.builds == builds, "TPFIFO: a kernel was built while serving")
    check(tp_launches["flash_attention"] == 0 and tp_launches["uct_select"] == 0,
          f"TPFIFO launches {tp_launches}: its prefill is chunked through "
          "decode, it searches nothing")
    check(tp_launches["rmsnorm"] > 0, "TPFIFO: rmsnorm never launched")

    counters = zero_lm_counters()
    eng = lockstep()
    ls_out, ls_wall = served(eng, "lockstep")
    ls_launches, ls_bodies = read_lm_counters(counters)
    ls_stats = {**served_stats(eng, ls_wall),
                "peak_memory_mb": peak_mb["lockstep"]}
    check(ls_launches["flash_attention"] == L * n_req
          and ls_bodies["tensor_cores"] == L * n_req,
          f"SlotEngine flash launches {ls_bodies} != {L} a prefill x "
          f"{n_req} admissions, on the tensor-core body")

    # the grain moves dispatch boundaries only; preemption is lossless
    for kw, what in (({"grain": 4}, "grain 4"),
                     ({"preempt_quanta": 1}, "preemption")):
        e = tpfifo(**kw)
        for _, r in requests(trace):
            e.submit(r)
        e.run()
        other = {r.rid: list(r.out) for r in e.finished}
        check(other == tp_out, f"TPFIFO {what}: tokens differ from grain "
                               f"{LM_SERVE_GRAIN}")
        if kw.get("preempt_quanta"):
            pre = e.stats().n_preemptions
            check(pre > 0, "TPFIFO preemption: the knob never fired")
    # TPFIFO against lockstep: reported, not checked (bf16 rounds a whole-
    # prompt flash prefill and a token-by-token decode differently)
    parts = {rid: next((i for i, (a, b) in enumerate(zip(o, ls_out[rid]))
                        if a != b), None) for rid, o in tp_out.items()}
    first_reqs = [r for _, r in requests(trace[:LM_SERVE_ENGINE["n_slots"]])]
    emit("lm_serve",
         config={"model": "smollm-135m", **LM_SERVE_TRACE, **LM_SERVE_ENGINE,
                 "grain": LM_SERVE_GRAIN, "policy": "fifo", "eos_id": -1,
                 "prompt_lens": [len(r["prompt"]) for _, r in trace]},
         tpfifo=tp_stats, lockstep=ls_stats,
         tpfifo_launches=tp_launches, lockstep_launches=ls_launches,
         grain_invariant=True, preemption_lossless=True,
         preemptions_with_preempt_quanta_1=pre, kernel_builds_while_serving=0,
         tpfifo_vs_lockstep={
             "requests_equal": sum(p is None for p in parts.values()),
             "first_parting_position": parts},
         tpfifo_profiled_tick=profile_one_step(torch, tpfifo(), first_reqs),
         lockstep_profiled_tick=profile_one_step(
             torch, lockstep(),
             [r for _, r in requests(trace[:LM_SERVE_ENGINE["n_slots"]])]),
         phase_seconds=time.perf_counter() - t_phase)
    return (add_counts(tp_launches, ls_launches),
            add_counts(tp_bodies, ls_bodies))


def lm_mcts_requests(vocab):
    """The lm_mcts_serve traffic: seeded prompts of 32-128 tokens."""
    import numpy as np
    from repro_torch.serve.engine import Request
    r = np.random.default_rng(3)
    lo, hi = LM_MCTS_PROMPTS
    return [Request(rid=i, prompt=r.integers(1, vocab, size=(int(n),)
                                              ).astype(np.int32),
                    max_new=LM_MCTS_MAX_NEW)
            for i, n in enumerate(r.integers(lo, hi + 1, LM_MCTS_REQUESTS))]


def phase_lm_mcts_serve(torch, model=None):
    """Search-guided LM serving at full width: 6 requests through
    ``TPFIFOMCTSEngine(4 slots, grain 1, preemption after 1 quantum)`` and
    ``MCTSSlotEngine(4 slots)``, every committed token a batched search of
    lm_batch's configuration at LM_MCTS_PLAYOUTS playouts. Checks: every request gets 2 tokens in the
    vocabulary, each engine run twice gives the same tokens, and
    ``MCTSSlotEngine``'s first tick commits exactly the best tokens of a
    direct ``mcts_decode_search_batch`` of its token matrix, lengths, mask
    and first split key. Reports each engine's peak memory over its timed
    run and one profiled tick with every slot busy."""
    import numpy as np
    from repro_torch import rng
    from repro_torch.serve import mcts_decode as md
    from repro_torch.serve.engine import MCTSSlotEngine
    from repro_torch.serve.tpfifo import TPFIFOMCTSEngine
    t_phase = time.perf_counter()
    mcfg, params, _ = model or lm_model(torch)
    dcfg = lm_batch_cfg(LM_MCTS_PLAYOUTS)
    kw = dict(max_prompt_len=LM_MCTS_MAX_PROMPT_LEN, eos_id=-1, seed=0,
              device="cuda")
    engines = {
        "tpfifo": lambda: TPFIFOMCTSEngine(params, mcfg, dcfg,
                                           n_slots=LM_MCTS_SLOTS, grain=1,
                                           preempt_quanta=1, **kw),
        "lockstep": lambda: MCTSSlotEngine(params, mcfg, dcfg,
                                           n_slots=LM_MCTS_SLOTS, **kw)}

    def served(name):
        eng = engines[name]()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in lm_mcts_requests(mcfg.vocab):
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        got = {r.rid: list(r.out) for r in eng.finished}
        check(len(got) == LM_MCTS_REQUESTS
              and all(len(o) == LM_MCTS_MAX_NEW for o in got.values())
              and all(0 <= t < mcfg.vocab for o in got.values() for t in o),
              f"{name} MCTS serving: {got}")
        return eng, got, wall, peak_mb

    counters = zero_lm_counters()
    runs = {name: served(name) for name in engines}
    launches, bodies = read_lm_counters(counters)
    for name in engines:
        _, again, _, _ = served(name)
        check(again == runs[name][1],
              f"{name} MCTS serving: tokens differ run to run")

    # MCTSSlotEngine's first tick == a direct batched search
    eng = engines["lockstep"]()
    for r in lm_mcts_requests(mcfg.vocab):
        eng.submit(r)
    eng._admit_free_slots()
    tokens, lens = eng.tokens.copy(), eng.lens.copy()
    mask = np.array([t is not None for t in eng.active])
    _, k = rng.split(eng.key)
    _, direct = md.mcts_decode_search_batch(params, mcfg, tokens, dcfg, k,
                                            prompt_lens=lens,
                                            request_mask=mask)
    eng.step()
    first = [t.req.out[0] for t in eng.active if t is not None]
    check(first == direct["best_tokens"][:len(first)],
          f"MCTSSlotEngine's first tick {first} != the direct batched "
          f"search {direct['best_tokens']}")
    # one tick of each engine with every slot busy: the second token of
    # the first LM_MCTS_SLOTS requests, after a tick that commits the first
    ticks = {name: profile_one_step(
                 torch, make(), lm_mcts_requests(mcfg.vocab)[:LM_MCTS_SLOTS],
                 warm_ticks=1)
             for name, make in engines.items()}
    emit("lm_mcts_serve",
         config={"model": "smollm-135m", "requests": LM_MCTS_REQUESTS,
                 "prompt_lens": [len(r.prompt)
                                 for r in lm_mcts_requests(mcfg.vocab)],
                 "max_new": LM_MCTS_MAX_NEW, "slots": LM_MCTS_SLOTS,
                 "max_prompt_len": LM_MCTS_MAX_PROMPT_LEN,
                 "tpfifo": {"grain": 1, "preempt_quanta": 1},
                 **LM_SEARCH, "n_playouts": LM_MCTS_PLAYOUTS},
         tokens={name: r[1] for name, r in runs.items()},
         run_twice_bit_identical=True, first_tick_equals_direct_search=True,
         **{name: {**served_stats(r[0], r[2]),
                   "searches": len(r[0].search_stats),
                   "peak_memory_mb": r[3], "profiled_tick": ticks[name]}
            for name, r in runs.items()},
         launches=launches, phase_seconds=time.perf_counter() - t_phase)
    return launches, bodies


# ------------------------------------------------------------- LM families ----
def family_model(torch, arch: str, overrides: dict | None = None):
    """One model at its published widths, bf16, random weights from seed 0,
    its config replaced by ``overrides`` (by default its LM_FAMILIES
    entry): (config, params, {"parameters", "init_s",
    "memory_after_init_mb"})."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    mcfg = get_config(arch).replace(
        **(LM_FAMILIES[arch] if overrides is None else overrides))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(mcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    return mcfg, params, {
        "parameters": api.n_params(mcfg), "init_s": time.perf_counter() - t0,
        "memory_after_init_mb": torch.cuda.memory_allocated() / 2**20}


def family_requests(vocab):
    """LM_FAMILY_LENS prompts of seeded tokens, LM_FAMILY_MAX_NEW each."""
    import numpy as np
    from repro_torch.serve.engine import Request
    r = np.random.default_rng(5)
    return [Request(rid=i, prompt=r.integers(1, vocab, size=(n,)).astype(
        np.int32), max_new=LM_FAMILY_MAX_NEW)
        for i, n in enumerate(LM_FAMILY_LENS)]


@contextlib.contextmanager
def moe_routing(torch, replay=None):
    """Record every MoE router decision (``models.moe.router_topk``: the
    float32 router probabilities and the top-k experts, call by call) into
    the list this yields; with ``replay`` (an earlier run's list), route
    each call by the earlier run's experts instead, each weighted by this
    run's own probability of it (what the router would give for that
    choice), while still recording this run's own choices."""
    from repro_torch.models import moe
    own = moe.router_topk
    calls: list = []

    def routed(logits, k, norm_topk):
        topi, topw = own(logits, k, norm_topk)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        calls.append((probs, topi))
        if replay is None:
            return topi, topw
        fixed = replay[len(calls) - 1][1]
        w = torch.gather(probs, -1, fixed.long())
        if norm_topk:
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return fixed, w

    moe.router_topk = routed
    try:
        yield calls
    finally:
        moe.router_topk = own


def routing_partings(torch, a: list, b: list) -> dict:
    """Where two runs' MoE routing parts: per router call the tokens whose
    top-k lists differ, and for each the gap, in run b's probabilities,
    between the experts the two runs chose at the first differing rank,
    against the largest difference of that token's probabilities between
    the runs. A parting is excused when its gap is within 2x that
    difference (a near-tie that rounding decides)."""
    parted = unexcused = 0
    worst_ratio = 0.0
    for (pa, ia), (pb, ib) in zip(a, b):
        diff = (ia != ib)
        rows = diff.any(-1)
        if not bool(rows.any()):
            continue
        first = diff.float().argmax(-1, keepdim=True)
        ea, eb = torch.gather(ia, -1, first).long(), torch.gather(ib, -1, first).long()
        gap = (torch.gather(pb, -1, ea) - torch.gather(pb, -1, eb)).abs()[..., 0]
        measured = (pa - pb).abs().amax(-1)
        ratio = (gap / torch.clamp(measured, min=1e-12))[rows]
        parted += int(rows.sum())
        unexcused += int((ratio > 2.0).sum())
        worst_ratio = max(worst_ratio, float(ratio.max()))
    return {"router_calls": len(a), "tokens_parted": parted,
            "tokens_unexcused": unexcused,
            "max_gap_over_measured_diff": worst_ratio}


def family_logits_vs_plain(torch, params, mcfg, extras=None):
    """The model's prefill (LM_FAMILY_CHECK_LEN seeded tokens on each of
    len(LM_FAMILY_LENS) rows, after the vlm's or encdec's ``extras``, one
    row each) and two decode steps on seeded tokens, with the kernels and
    with their plain versions, in bf16 and on a float32 copy of the
    weights:

    - float32: kernels vs plain within FAMILY_F32_TOL of the largest logit;
    - bf16: the kernel run no farther from the float32 plain run than the
      plain bf16 run is (RMS over every logit, at most
      FAMILY_BF16_RMS_RATIO times). Rounding to bf16 alone moves a deep
      random-weight model's logits by about half their range (zamba2-7b
      and xlstm-1.3b, measured on the card), so two bf16 runs that round
      differently part by as much, whoever rounds;
    - bf16, the MoE models (2 layers, where that does not happen): kernels
      vs plain within LOGITS_TOL of the largest logit.

    On a MoE model every run takes the bf16 kernel run's expert choices
    (``moe_routing``): a near-tie among 128 or 160 router probabilities
    flips with a rounding and moves its token's output far more than any
    kernel does; each run's own choices are recorded beside, and every
    place where the plain run's part from the kernel run's must be such a
    near-tie (``routing_partings``)."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import TransformerLM
    B, P = len(LM_FAMILY_LENS), LM_FAMILY_CHECK_LEN
    extras = extras or {}
    # the vlm's decode positions follow its patch prefix
    off = extras["patches"].shape[1] if "patches" in extras else 0
    g = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(1, mcfg.vocab, (B, P + 2), generator=g,
                         device="cuda", dtype=torch.int32)

    def run(ctx, prm, cfg, replay):
        with ctx(), moe_routing(torch, replay) as calls:
            logits, cache = api.prefill(
                prm, cfg, {"tokens": toks[:, :P], **extras}, off + P + 2)
            out = [logits[:, 0].float()]
            for t in range(2):
                logits, cache = api.decode(prm, cfg, toks[:, P + t:P + t + 1],
                                           off + P + t, cache)
                out.append(logits[:, 0].float())
        return out, calls

    kernel, route = run(contextlib.nullcontext, params, mcfg, None)
    replay = route or None
    plain, plain_route = run(ops.plain_versions, params, mcfg, replay)
    f32 = mcfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = TransformerLM(f32, tree_map(lambda t: t.detach().float(),
                                      params.tree()))
    kernel32, route32 = run(contextlib.nullcontext, p32, f32, replay)
    plain32, plain_route32 = run(ops.plain_versions, p32, f32, replay)
    del p32
    check(all(bool(torch.isfinite(t).all())
              for r in (kernel, plain, kernel32, plain32) for t in r),
          f"{mcfg.name}: non-finite logits")
    maxerr = lambda a, b: [float((x - y).abs().max()) for x, y in zip(a, b)]
    rms = lambda a, b: [float((x - y).pow(2).mean().sqrt())
                        for x, y in zip(a, b)]
    scale32 = max(float(t.abs().max()) for t in plain32)
    err32 = maxerr(kernel32, plain32)
    check(max(err32) <= FAMILY_F32_TOL * scale32,
          f"{mcfg.name}: float32 kernels vs plain max abs err {err32} above "
          f"{FAMILY_F32_TOL} x {scale32}")
    rms_kernel, rms_plain = rms(kernel, plain32), rms(plain, plain32)
    ratio = max(a / b for a, b in zip(rms_kernel, rms_plain))
    check(ratio <= FAMILY_BF16_RMS_RATIO,
          f"{mcfg.name}: the bf16 kernel run is {ratio:.3f}x as far from "
          f"float32 as the plain bf16 run (RMS {rms_kernel} vs {rms_plain})")
    scale = max(float(t.abs().max()) for t in plain)
    err = maxerr(kernel, plain)
    if mcfg.family == "moe":
        check(max(err) <= LOGITS_TOL * scale,
              f"{mcfg.name}: kernels vs plain logits max abs err {err} above "
              f"{LOGITS_TOL} x {scale}")
    routing = None
    if route:
        routing = {"bfloat16": routing_partings(torch, route, plain_route),
                   "float32": routing_partings(torch, route32, plain_route32)}
        check(all(r["tokens_unexcused"] == 0 for r in routing.values()),
              f"{mcfg.name}: the plain run's routing parts from the kernel "
              f"run's beyond rounding: {routing}")
    return {"rows": B, "prompt_len": P, "decode_steps": 2,
            "float32_max_abs_err": err32, "float32_max_abs_logit": scale32,
            "bfloat16_max_abs_err": err, "bfloat16_max_abs_logit": scale,
            "bfloat16_rms_from_float32": {"kernels": rms_kernel,
                                          "plain": rms_plain,
                                          "max_ratio": ratio},
            "tolerance": {
                "float32": f"{FAMILY_F32_TOL} x max |logit|",
                "bfloat16": f"RMS from float32 <= {FAMILY_BF16_RMS_RATIO} x "
                            "the plain bf16 run's; MoE models also "
                            f"{LOGITS_TOL} x max |logit|"},
            "moe_routing": routing}


def family_timings(torch, params, mcfg):
    """Prefill ms of one LM_FAMILY_CHECK_LEN-token prompt, ms per decode
    step of len(LM_FAMILY_LENS) rows (host clock, device synchronised), and
    one profiled decode step's CUDA kernels, device ms and idle share."""
    from repro_torch.models import api
    B, P = len(LM_FAMILY_LENS), LM_FAMILY_CHECK_LEN
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(1, mcfg.vocab, (B, P), generator=g, device="cuda",
                         dtype=torch.int32)
    steps = 8
    prefill = lambda: api.prefill(params, mcfg, {"tokens": toks[:1]}, P)
    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    _, cache = api.prefill(params, mcfg, {"tokens": toks}, P + steps + 2)
    tok = toks[:, -1:]
    api.decode(params, mcfg, tok, P, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        api.decode(params, mcfg, tok, P + t, cache)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / steps
    return {"prefill_ms": prefill_ms, "prefill_tokens": P,
            "decode_step_ms": decode_ms, "decode_rows": B,
            "profiled_decode_step": profiled_decode_step(
                torch, params, mcfg, tok, P + steps, cache)}


def profiled_decode_step(torch, params, mcfg, tok, pos, cache):
    """One decode step under the profiler: its CUDA kernels, device ms and
    idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.decode(params, mcfg, tok, pos, cache)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, device_ms = cuda_activity(prof)
    check(device_ms, f"{mcfg.name}: torch.profiler saw no CUDA kernel in a "
                     "decode step")
    return {"cuda_kernels": kernels, "device_ms": device_ms,
            "wall_ms": wall_ms, "device_idle_share": 1 - device_ms / wall_ms}


def family_serving(torch, params, mcfg):
    """The family's main path: LM_FAMILY_LENS requests, greedy, no eos,
    through SlotEngine and then TPFIFOEngine (each's launches counted from
    zero), then each engine again: the same tokens."""
    from repro_torch.serve.engine import SlotEngine
    from repro_torch.serve.tpfifo import TPFIFOEngine
    kw = dict(n_slots=len(LM_FAMILY_LENS), max_len=LM_FAMILY_MAX_LEN,
              eos_id=-1, device="cuda")
    engines = {"lockstep": lambda: SlotEngine(params, mcfg, **kw),
               "tpfifo": lambda: TPFIFOEngine(params, mcfg,
                                              grain=LM_FAMILY_GRAIN, **kw)}
    out, launches, bodies = {}, {}, {}
    for name, make in engines.items():
        eng = make()
        counters = zero_lm_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in family_requests(mcfg.vocab):
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name], bodies[name] = read_lm_counters(counters)
        got = {r.rid: list(r.out) for r in eng.finished}
        check(len(got) == len(LM_FAMILY_LENS)
              and all(len(o) == LM_FAMILY_MAX_NEW for o in got.values())
              and all(0 <= t < mcfg.vocab for o in got.values() for t in o),
              f"{mcfg.name} {name}: served {got}")
        again = make()
        for r in family_requests(mcfg.vocab):
            again.submit(r)
        again.run()
        check({r.rid: list(r.out) for r in again.finished} == got,
              f"{mcfg.name} {name}: tokens differ run to run")
        out[name] = {**served_stats(eng, wall), "tokens_out": got,
                     "launches": launches[name]}
    return out, add_counts(*launches.values()), add_counts(*bodies.values())


def family_mcts(torch, params, mcfg):
    """One search-guided token on the model (MCTSSlotEngine, one slot):
    W = 64 lanes, LM_FAMILY_MCTS_PLAYOUTS playouts, branch 8, depth 6,
    rollout 8; counted from zero; run twice, the same token."""
    from repro_torch.serve.engine import MCTSSlotEngine, Request
    from repro_torch.serve.mcts_decode import MCTSDecodeConfig
    dcfg = MCTSDecodeConfig(**{**LM_SEARCH, "n_playouts":
                               LM_FAMILY_MCTS_PLAYOUTS})
    req = family_requests(mcfg.vocab)[-1]

    def run():
        eng = MCTSSlotEngine(params, mcfg, dcfg, n_slots=1,
                             max_prompt_len=len(req.prompt) + 1, eos_id=-1,
                             device="cuda")
        eng.submit(Request(rid=0, prompt=req.prompt, max_new=1))
        eng.run()
        return eng

    counters = zero_lm_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bodies = read_lm_counters(counters)
    tok = eng.finished[0].out
    check(len(tok) == 1 and 0 <= tok[0] < mcfg.vocab,
          f"{mcfg.name} MCTS: committed {tok}")
    check(run().finished[0].out == tok,
          f"{mcfg.name} MCTS: the token differs run to run")
    st = eng.search_stats[0]
    return ({"token": tok[0], "seconds": wall, "tokens_per_s": 1 / wall,
             "prompt_len": len(req.prompt), "playouts": st["playouts"],
             "tree_nodes": st["tree_nodes"], "launches": launches,
             **{k: getattr(dcfg, k) for k in (
                 "n_workers", "n_tasks", "branch", "max_depth",
                 "rollout_len")}},
            launches, bodies)


def phase_lm_families(torch):
    """The MoE, MLA, zamba2 hybrid and xLSTM models at their published
    widths (LM_FAMILIES; bf16, seed-0 random weights), one at a time, each
    freed before the next (``lm_kernels`` holds and times the kernels at
    their shapes): per model its parameters and memory, its prefill and
    decode logits with the kernels against the plain
    versions, prefill ms, ms per decode step and a profiled decode step,
    and its main path: LM_FAMILY_LENS requests of LM_FAMILY_MAX_NEW greedy
    tokens through ``SlotEngine`` and ``TPFIFOEngine`` (run twice, the same
    tokens); on xlstm-1.3b one search-guided token through
    ``MCTSSlotEngine``. Checks each kernel's launches on the path: flash
    (tensor-core body) on qwen3-moe's and zamba2's SlotEngine prefills,
    none on deepseek-v2 (MLA runs sdpa: its v head dim is not q's) or
    xlstm; rmsnorm on every model; uct_select on the xLSTM search."""
    import gc
    t_phase = time.perf_counter()
    models, launches, bodies = {}, {}, {}
    for arch in LM_FAMILIES:
        t_model = time.perf_counter()
        mcfg, params, info = family_model(torch, arch)
        info["logits_vs_plain"] = family_logits_vs_plain(torch, params, mcfg)
        info.update(family_timings(torch, params, mcfg))
        torch.cuda.reset_peak_memory_stats()
        info["serving"], ln, bd = family_serving(torch, params, mcfg)
        if arch == LM_FAMILY_MCTS_ARCH:
            info["mcts"], ln2, bd2 = family_mcts(torch, params, mcfg)
            check(ln2["uct_select"] > 0, f"{arch}: uct_select never launched")
            ln, bd = add_counts(ln, ln2), add_counts(bd, bd2)
        info["peak_memory_mb"] = torch.cuda.max_memory_allocated() / 2**20
        check(ln["rmsnorm"] > 0, f"{arch}: rmsnorm never launched")
        flash_body = {"qwen3-moe-235b-a22b": "tensor_cores",
                      "zamba2-7b": "tensor_cores"}.get(arch)
        if flash_body:
            check(bd[flash_body] > 0 and bd[flash_body] == ln["flash_attention"],
                  f"{arch}: flash launches {bd}, expected the {flash_body} "
                  "body")
        else:
            check(ln["flash_attention"] == 0,
                  f"{arch}: flash launched {ln['flash_attention']} times")
        info["launches"], info["launches_by_body"] = ln, bd
        info["config"] = {"arch": arch, **LM_FAMILIES[arch],
                          "layers": mcfg.n_layers, "d_model": mcfg.d_model}
        info["model_seconds"] = time.perf_counter() - t_model
        models[arch] = info
        launches, bodies = add_counts(launches, ln), add_counts(bodies, bd)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    emit("lm_families",
         config={"requests_prompt_lens": list(LM_FAMILY_LENS),
                 "max_new": LM_FAMILY_MAX_NEW, "max_len": LM_FAMILY_MAX_LEN,
                 "tpfifo_grain": LM_FAMILY_GRAIN, "greedy": True,
                 "eos_id": -1, "mcts_arch": LM_FAMILY_MCTS_ARCH,
                 "mcts_playouts": LM_FAMILY_MCTS_PLAYOUTS},
         models=models, launches=launches, launches_by_body=bodies,
         phase_seconds=time.perf_counter() - t_phase)
    return launches, bodies


# ------------------------------------------------- vlm and encoder-decoder ----
def ve_inputs(torch, mcfg):
    """The phase's traffic: VE_ROWS rows of VE_PROMPT_LEN seeded tokens and
    the family's stub input, VE_SRC_LEN rows a request: patches as
    ``models.vlm.fake_patches`` makes them, or unit-normal frames, bf16."""
    from repro_torch.models import vlm
    g = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(1, mcfg.vocab, (VE_ROWS, VE_PROMPT_LEN), generator=g,
                         device="cuda", dtype=torch.int32)
    if mcfg.family == "vlm":
        check(mcfg.n_patches == VE_SRC_LEN, f"{mcfg.name}: n_patches")
        return toks, {"patches": vlm.fake_patches(mcfg, VE_ROWS, g)}
    frames = torch.randn(VE_ROWS, VE_SRC_LEN, mcfg.vision_width, generator=g,
                         device="cuda").to(mcfg.cdtype)
    return toks, {"frames": frames}


def ve_greedy(torch, params, mcfg, toks, extras):
    """The main path: one prefill of the VE_ROWS rows, then VE_DECODE_STEPS
    greedy decode steps, each feeding the last step's argmax (host clock,
    device synchronised). Returns (the tokens fed, a row each; prefill ms;
    ms per decode step; the cache; the last token and position)."""
    from repro_torch.models import api
    off = extras["patches"].shape[1] if "patches" in extras else 0
    pos0 = off + toks.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, mcfg, {"tokens": toks, **extras},
                                pos0 + VE_DECODE_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fed = []
    for t in range(VE_DECODE_STEPS):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        fed.append(tok)
        logits, cache = api.decode(params, mcfg, tok, pos0 + t, cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(bool(torch.isfinite(logits).all()), f"{mcfg.name}: non-finite logits")
    return (torch.cat(fed, 1).tolist(), 1e3 * (t1 - t0),
            1e3 * (t2 - t1) / VE_DECODE_STEPS, cache, fed[-1],
            pos0 + VE_DECODE_STEPS - 1)


def ve_search_cfg():
    from repro_torch.serve.mcts_decode import MCTSDecodeConfig
    return MCTSDecodeConfig(**{**LM_SEARCH, "n_playouts": VE_SEARCH_PLAYOUTS})


def ve_vlm_search_refused(torch, params, mcfg, toks, extras):
    """The vlm search sizes its cache by the prompt alone, as the reference
    does: at full width the 256-patch prefix does not fit, and
    ``mcts_decode_search`` must raise ``ValueError`` (the reference raises
    in its prefill) with no kernel launched."""
    from repro_torch import rng
    from repro_torch.serve.mcts_decode import mcts_decode_search
    dcfg = ve_search_cfg()
    counters = zero_lm_counters()
    try:
        mcts_decode_search(params, mcfg, toks[0], dcfg, rng.key(0, "cuda"),
                           {"patches": extras["patches"][:1]})
    except ValueError as e:
        msg = str(e)
    else:
        check(False, f"{mcfg.name}: the search with patches did not raise")
    launched, _ = read_lm_counters(counters)
    check(sum(launched.values()) == 0,
          f"{mcfg.name}: the refused search launched {launched}")
    return {"error": msg, "launches": launched,
            "max_len": VE_PROMPT_LEN + dcfg.max_depth + dcfg.rollout_len + 1,
            "prefill_positions": VE_SRC_LEN + VE_PROMPT_LEN}


def ve_tree_parts(torch, a, b) -> list:
    """The fields in which two trees (or forests) part: every field but wins
    exactly, wins within VE_WINS_RTOL."""
    from repro_torch.core.tree import Tree
    return [f for f, x, y in zip(Tree._fields, a, b)
            if not (torch.allclose(x, y, rtol=VE_WINS_RTOL, atol=1e-6)
                    if f == "wins" else torch.equal(x, y))]


def ve_searches(torch, params, mcfg, toks, frames):
    """seamless's search-guided tokens: one ``mcts_decode_search`` for
    request 0 and one ``mcts_decode_search_batch`` for the VE_ROWS requests
    (64 lanes a request, each request its own frames), launches counted
    from zero; each run again, bit-identical."""
    from repro_torch import parity, rng
    from repro_torch.serve import mcts_decode as md
    dcfg = ve_search_cfg()
    key = rng.key(11, "cuda")
    runs = {
        "single": lambda: md.mcts_decode_search(
            params, mcfg, toks[0], dcfg, key, {"frames": frames[:1]}),
        "batch": lambda: md.mcts_decode_search_batch(
            params, mcfg, toks, dcfg, key, batch_extras={"frames": frames})}
    out, launches, bodies = {}, {}, {}
    for name, run in runs.items():
        counters = zero_lm_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, st = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name], bodies[name] = read_lm_counters(counters)
        again, st2 = run()
        differ = parity.differing_fields(tree, again)
        check(not differ, f"{mcfg.name} {name} search: run twice, the trees "
                          f"differ in {differ}")
        best = st.get("best_tokens", st.get("best_token"))
        check(best == st2.get("best_tokens", st2.get("best_token")),
              f"{mcfg.name} {name} search: best tokens differ run to run")
        out[name] = {
            "best": best, "seconds": wall, "tokens_per_s":
                (VE_ROWS if name == "batch" else 1) / wall,
            "prefill_s": st["prefill_s"], "search_s": st["time_s"],
            "playouts": st["playouts"], "playouts_per_s": st["playouts_per_s"],
            "sync_iterations": st["sync_iterations"],
            "tree_nodes": st["tree_nodes"], "launches": launches[name],
            "bit_identical_run_twice": True}
    return out, add_counts(*launches.values()), add_counts(*bodies.values())


def ve_searches_vs_plain(torch, params, mcfg, toks, frames):
    """On a float32 copy of the weights, each seamless search with the
    kernels against the same search under ``ops.plain_versions()``, and the
    search stepped both ways (``parity.step_decode_search`` / ``_batch``):
    its root, leaf and rollout logits agree within LOGITS_TOL of the
    largest logit (the kernels at the search's 64- and 256-lane prefills
    and decode steps), it parts only at decisions its measured error
    explains, and the trees are equal (wins to VE_WINS_RTOL) unless the
    stepped search parted."""
    from repro_torch import parity, rng
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve import mcts_decode as md
    dcfg = ve_search_cfg()
    key = rng.key(11, "cuda")
    f32 = mcfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = TransformerLM(f32, tree_map(lambda t: t.detach().float(),
                                      params.tree()))
    fr = frames.float()
    runs = {
        "single": (lambda: md.mcts_decode_search(
            p32, f32, toks[0], dcfg, key, {"frames": fr[:1]})[0],
            lambda: parity.step_decode_search(
                p32, f32, dcfg, toks[0], key, ops.plain_versions,
                batch_extras={"frames": fr[:1]})),
        "batch": (lambda: md.mcts_decode_search_batch(
            p32, f32, toks, dcfg, key, batch_extras={"frames": fr})[0],
            lambda: parity.step_decode_search_batch(
                p32, f32, dcfg, toks, key, ops.plain_versions,
                batch_extras={"frames": fr}))}
    out = {}
    for name, (run, step) in runs.items():
        kernels = run()
        with ops.plain_versions():
            plain = run()
        parts = ve_tree_parts(torch, kernels, plain)
        rep = step()
        scale = rep["max_abs_logit"]
        for err in ("root_err", "leaf_err", "rollout_err"):
            check(rep[err] <= LOGITS_TOL * scale,
                  f"{mcfg.name} float32 {name} search {err}: kernels vs "
                  f"plain max abs err {rep[err]} above {LOGITS_TOL} x {scale}")
        check(not rep["unexcused"],
              f"{mcfg.name} float32 {name} search: kernels and plain versions "
              "part at decisions their measured error does not explain: "
              f"{rep['unexcused'][:3]}")
        check(not parts or rep["parted_at"] is not None,
              f"{mcfg.name} float32 {name} search: the trees part in {parts}, "
              "yet the stepped search never parted")
        out[name] = {"trees_equal": not parts, "parted_fields": parts,
                     "wins_max_abs_diff": float(
                         (kernels.wins - plain.wins).abs().max()),
                     "stepped": {k: v for k, v in rep.items()
                                 if k != "unexcused"}}
    del p32
    return {**out, "tolerance": f"logits {LOGITS_TOL} x max |logit|; every "
                                "parting decision within 2 x its measured "
                                "error; every tree field but wins equal, wins "
                                f"to rtol {VE_WINS_RTOL}, unless the stepped "
                                "search parted"}


def phase_lm_vlm_encdec(torch):
    """paligemma-3b and seamless-m4t-medium whole at their published widths
    (VE_MODELS: bf16, seed-0 random weights, use_flash), one at a time,
    each freed before the next (``lm_kernels`` holds and times the kernels
    at their shapes): per model its parameters and memory, its logits with
    the kernels against the plain versions (``family_logits_vs_plain``'s
    rules, after the model's stub input), and its main path counted from
    zero: VE_ROWS requests of VE_SRC_LEN patches or frames and
    VE_PROMPT_LEN tokens, a prefill and VE_DECODE_STEPS greedy steps (prefill
    ms, ms per decode step, tokens/s, peak memory, run twice with the same
    tokens, one profiled step); on seamless also one search-guided token
    and one batched token for the VE_ROWS requests (``ve_searches``), held
    on float32 weights against the plain versions. On paligemma the
    search with patches must be refused with no kernel launched. Checks
    each kernel's launches on the path: rmsnorm on both, flash (its
    tensor-core body) on seamless's decoder prefills and never on
    paligemma (prefix-LM attention runs ``sdpa``, as in the reference),
    uct_select on seamless's searches."""
    import gc
    t_phase = time.perf_counter()
    models, launches, bodies = {}, {}, {}
    for arch in VE_MODELS:
        t_model = time.perf_counter()
        mcfg, params, info = family_model(torch, arch, {"use_flash": True})
        toks, extras = ve_inputs(torch, mcfg)
        info["logits_vs_plain"] = family_logits_vs_plain(torch, params, mcfg,
                                                         extras)
        torch.cuda.reset_peak_memory_stats()
        counters = zero_lm_counters()
        out, prefill_ms, step_ms, cache, tok, pos = ve_greedy(
            torch, params, mcfg, toks, extras)
        ln, bd = read_lm_counters(counters)
        info["peak_memory_mb"] = torch.cuda.max_memory_allocated() / 2**20
        again = ve_greedy(torch, params, mcfg, toks, extras)[0]
        check(again == out, f"{arch}: greedy tokens differ run to run")
        info.update(
            tokens_out=out, prefill_ms=prefill_ms,
            prefill_positions=pos + 1 - VE_DECODE_STEPS,
            decode_step_ms=step_ms, decode_rows=VE_ROWS,
            decode_tokens_per_s=VE_ROWS * 1e3 / step_ms,
            tokens_per_s=VE_ROWS * VE_DECODE_STEPS * 1e3 / (
                prefill_ms + VE_DECODE_STEPS * step_ms),
            profiled_decode_step=profiled_decode_step(torch, params, mcfg,
                                                      tok, pos, cache))
        del cache
        if mcfg.family == "vlm":
            info["search_refused"] = ve_vlm_search_refused(torch, params,
                                                           mcfg, toks, extras)
            check(ln["flash_attention"] == 0,
                  f"{arch}: flash launched {ln['flash_attention']} times")
        else:
            torch.cuda.reset_peak_memory_stats()
            info["mcts"], ln2, bd2 = ve_searches(torch, params, mcfg, toks,
                                                 extras["frames"])
            info["mcts"]["peak_memory_mb"] = \
                torch.cuda.max_memory_allocated() / 2**20
            check(ln2["uct_select"] > 0, f"{arch}: uct_select never launched")
            ln, bd = add_counts(ln, ln2), add_counts(bd, bd2)
            check(bd["tensor_cores"] > 0
                  and bd["tensor_cores"] == ln["flash_attention"],
                  f"{arch}: flash launches {bd}, expected the tensor-core "
                  "body")
            info["mcts_vs_plain"] = ve_searches_vs_plain(
                torch, params, mcfg, toks, extras["frames"])
        check(ln["rmsnorm"] > 0, f"{arch}: rmsnorm never launched")
        info["launches"], info["launches_by_body"] = ln, bd
        info["config"] = {"arch": arch, "use_flash": True, "family":
                          mcfg.family, "layers": mcfg.n_layers,
                          "encoder_layers": mcfg.n_enc_layers,
                          "d_model": mcfg.d_model, "vocab": mcfg.vocab}
        info["model_seconds"] = time.perf_counter() - t_model
        models[arch] = info
        launches, bodies = add_counts(launches, ln), add_counts(bodies, bd)
        del params, extras
        gc.collect()
        torch.cuda.empty_cache()
    emit("lm_vlm_encdec",
         config={"rows": VE_ROWS, "source_len": VE_SRC_LEN,
                 "prompt_len": VE_PROMPT_LEN,
                 "decode_steps": VE_DECODE_STEPS, "greedy": True,
                 "search": {**LM_SEARCH, "n_playouts": VE_SEARCH_PLAYOUTS}},
         models=models, launches=launches, launches_by_body=bodies,
         phase_seconds=time.perf_counter() - t_phase)
    return launches, bodies


# ---------------------------------------------------------------- training ----
def train_grads(torch, mcfg, params, batch):
    """(loss, {path: grad}) of the training loss, and the rmsnorm and flash
    counts it made: kernel launches, plain backwards, plain forwards."""
    from repro_torch.train import step as step_mod
    counters, plain = lm_train_counters()
    with plain:
        loss, grads = step_mod._value_and_grad(mcfg, params, batch)
        torch.cuda.synchronize()
    return float(loss), grads, read_train_counters(counters, plain)


class _PlainForwards:
    """Counts the plain versions' forwards (``kernels.ref.rmsnorm`` and
    ``flash_attention``, what ``ops`` dispatches to off the kernels) while
    active; the backward's recomputations go through the kernel modules'
    own references and are counted by the wrappers' ``plain_backwards``."""

    def __init__(self):
        self.calls = {"rmsnorm": 0, "flash_attention": 0}

    def __enter__(self):
        from repro_torch.kernels import ref
        self._real = {n: getattr(ref, n) for n in self.calls}
        for n, f in self._real.items():
            setattr(ref, n, self._counting(n, f))
        return self

    def _counting(self, name, f):
        def g(*a, **kw):
            self.calls[name] += 1
            return f(*a, **kw)
        return g

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        for n, f in self._real.items():
            setattr(ref, n, f)


def lm_train_counters():
    """Zero the two training kernels' counters (launches, per-body, plain
    backwards) just before a path runs; a plain-forward counter with them."""
    counters = zero_lm_counters()
    for name in ("rmsnorm", "flash_attention"):
        counters[name].plain_backwards = 0
    return counters, _PlainForwards()


def read_train_counters(counters, plain) -> dict:
    from repro_torch.kernels import flash_attention as fa
    return {name: {"launches": counters[name].launches,
                   "plain_backwards": counters[name].plain_backwards,
                   "plain_forwards": plain.calls[name]}
            for name in ("rmsnorm", "flash_attention")} | {
        "flash_by_body": dict(fa.flash_attention.launches_by_body)}


def grads_vs_plain(torch, mcfg, batch, what: str) -> dict:
    """The loss and every leaf's gradient with the kernels against
    ``ops.plain_versions()`` on the same float32 weights (seed 0) and
    batch: the loss within LM_TRAIN_GRAD_LOSS_RTOL, every leaf a gradient
    within LM_TRAIN_GRAD_TOL of its largest magnitude; the forward on the
    kernels (61 rmsnorm launches and as many plain backwards; 30 flash
    launches on the body ``body_for`` names when ``use_flash``), no plain
    forward."""
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.models import api
    params = api.init_params(mcfg, seed=0, device="cuda", requires_grad=True)
    loss_k, g_k, counts = train_grads(torch, mcfg, params, batch)
    with ops.plain_versions():
        loss_p, g_p, plain_counts = train_grads(torch, mcfg, params, batch)
    L = mcfg.n_layers
    norms = 2 * L + 1
    check(counts["rmsnorm"] == {"launches": norms, "plain_backwards": norms,
                                "plain_forwards": 0},
          f"{what}: rmsnorm counts {counts['rmsnorm']} with the kernels")
    body = fa.body_for(mcfg.cdtype, mcfg.hd)
    n_flash = L if mcfg.use_flash else 0
    check(counts["flash_attention"] == {"launches": n_flash,
                                        "plain_backwards": n_flash,
                                        "plain_forwards": 0}
          and counts["flash_by_body"][body] == n_flash,
          f"{what}: flash counts {counts} with the kernels")
    check(plain_counts["rmsnorm"]["launches"] == 0
          and plain_counts["flash_attention"]["launches"] == 0,
          f"{what}: a kernel launched under plain_versions()")
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_err <= LM_TRAIN_GRAD_LOSS_RTOL,
          f"{what}: loss {loss_k} with the kernels, {loss_p} plain")
    worst, worst_leaf = 0.0, None
    for path, gp in g_p.items():
        gk = g_k[path]
        check(gk is not None and gp is not None
              and gk.shape == gp.shape and bool(torch.isfinite(gk).all()),
              f"{what}: {path} has no finite gradient with the kernels")
        scale = float(gp.abs().max())
        err = float((gk.float() - gp.float()).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_leaf = err, path
    check(worst <= LM_TRAIN_GRAD_TOL,
          f"{what}: {worst_leaf} gradient {worst} of its largest value "
          "from the plain versions'")
    n_leaves = len(g_p)
    del params, g_k, g_p
    torch.cuda.empty_cache()
    return {"loss": loss_k, "loss_plain": loss_p, "loss_rel_err": loss_err,
            "leaves": n_leaves, "max_leaf_err": worst,
            "max_leaf_err_path": worst_leaf, "flash_body": body
            if mcfg.use_flash else None, "counts": counts}


def bf16_loss_vs_plain(torch, mcfg, batch) -> dict:
    """The bf16 model's loss (``"model"``-order norms, flash on the
    tensor-core body) with the kernels against the plain versions, within
    LOGITS_TOL of the plain loss; its gradients finite and on every leaf."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    params = api.init_params(mcfg, seed=0, device="cuda", requires_grad=True)
    loss_k, g_k, counts = train_grads(torch, mcfg, params, batch)
    with ops.plain_versions():
        loss_p, _, _ = train_grads(torch, mcfg, params, batch)
    check(counts["flash_by_body"]["tensor_cores"] == mcfg.n_layers,
          f"bf16 loss: flash ran on {counts['flash_by_body']}")
    check(abs(loss_k - loss_p) <= LOGITS_TOL * abs(loss_p),
          f"bf16 loss {loss_k} with the kernels, {loss_p} plain")
    check(all(g is not None and bool(torch.isfinite(g).all())
              for g in g_k.values()), "bf16: a gradient missing or not finite")
    return {"loss": loss_k, "loss_plain": loss_p,
            "rel_diff": abs(loss_k - loss_p) / abs(loss_p), "counts": counts}


def kernel_grads_at_training_shapes(torch) -> dict:
    """Each training kernel through its autograd wrapper against the plain
    version with autograd, on the same inputs and cotangent, at the
    training shapes: rmsnorm (1,024 x 576) in both rounding orders and both
    dtypes, flash (4, 9 over 3, 256, 64) bshd on both bodies (bf16: tensor
    cores, float32: CUDA cores). The forward is the kernel's (within the
    checks' tolerances of the plain forward); the gradients equal the plain
    version's bit for bit (the backward is the plain version's)."""
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device="cuda").manual_seed(21)
    out = {"rmsnorm": [], "flash_attention": []}

    def both(kernel_call, plain_call, inputs):
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        ys = [t.detach().clone().requires_grad_(True) for t in inputs]
        got = kernel_call(*xs)
        want = plain_call(*ys)
        cot = torch.randn(got.shape, generator=g, device="cuda").to(got.dtype)
        gk = torch.autograd.grad(got, xs, cot)
        gp = torch.autograd.grad(want, ys, cot)
        torch.cuda.synchronize()
        return got, want, all(torch.equal(a, b) for a, b in zip(gk, gp))

    N, D = LM_TRAIN_NORM_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        for order in ("kernel", "model"):
            x = (3 * torch.randn(N, D, generator=g, device="cuda")).to(dt)
            w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(dt)
            before = rn.rmsnorm.launches
            got, want, equal = both(
                lambda a, b: rn.rmsnorm(a, b, 1e-5, order=order),
                lambda a, b: ref.rmsnorm(a, b, 1e-5, order=order), (x, w))
            check(rn.rmsnorm.launches == before + 1,
                  "rmsnorm under grad did not launch the kernel")
            name = "float32" if dt == torch.float32 else "bfloat16"
            got, want = got.detach(), want.detach()
            err = float((got.float() - want.float()).abs().max())
            if dt == torch.float32:
                check(err <= RMSNORM_F32_TOL * 10, f"rmsnorm {order} f32 "
                      f"forward under grad: {err}")
            else:
                steps = int(bf16_steps(torch, got, want).max())
                check(steps <= RMSNORM_BF16_STEPS[order],
                      f"rmsnorm {order} bf16 forward under grad: {steps}")
            check(equal, f"rmsnorm {order} {name}: gradients differ from "
                         "the plain version's")
            out["rmsnorm"].append({"dtype": name, "order": order,
                                   "forward_max_abs_err": err,
                                   "grads_equal_plain": True})
    B, H, Hkv, S, d = LM_TRAIN_FLASH_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(B, S, H, d, generator=g, device="cuda").to(dt)
        k = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(dt)
        v = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(dt)
        body = fa.body_for(dt, d)
        before = dict(fa.flash_attention.launches_by_body)
        got, want, equal = both(
            lambda a, b, c: fa.flash_attention(a, b, c, layout="bshd"),
            lambda a, b, c: fa._plain(a, b, c, True, None, "bshd"), (q, k, v))
        check(fa.flash_attention.launches_by_body[body] == before[body] + 1,
              f"flash under grad did not launch the {body} body")
        name = "float32" if dt == torch.float32 else "bfloat16"
        err = float((got.detach().float() - want.detach().float()).abs().max())
        check(err <= FLASH_TOL[name], f"flash {name} forward under grad: {err}")
        check(equal, f"flash {name}: gradients differ from the plain version's")
        out["flash_attention"].append({"dtype": name, "body": body,
                                       "forward_max_abs_err": err,
                                       "grads_equal_plain": True})
    # the CUDA kernels one backward of each launches (bf16, the training
    # shapes): what a hand-written backward kernel would replace
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(N, D, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.ones(D, device="cuda", dtype=torch.bfloat16)
    q = torch.randn(B, S, H, d, generator=g, device="cuda").to(torch.bfloat16)
    kv = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(
        torch.bfloat16)
    calls = {"rmsnorm": (lambda a, b: rn.rmsnorm(a, b, 1e-5, order="model"),
                         (x, w)),
             "flash_attention": (lambda a, b, c: fa.flash_attention(
                 a, b, c, layout="bshd"), (q, kv, kv.clone()))}
    for name, (call, inputs) in calls.items():
        xs = [t.clone().requires_grad_(True) for t in inputs]
        y = call(*xs)
        cot = torch.ones_like(y)
        torch.autograd.grad(call(*xs), xs, cot)      # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(y, xs, cot)
            torch.cuda.synchronize()
        kernels, device_ms = cuda_activity(prof)
        out[name + "_backward"] = {"cuda_kernels": kernels,
                                   "device_ms": device_ms}
    return out


def profile_one_train_step(torch, step_fn, state, batch) -> dict:
    """One training step under the profiler (CUDA activity): its kernels,
    device ms, wall ms and idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, device_ms = cuda_activity(prof)
    check(device_ms, "torch.profiler saw no CUDA kernel in a training step")
    return {"cuda_kernels": kernels, "device_ms": device_ms,
            "wall_ms": wall_ms, "device_idle_share": 1 - device_ms / wall_ms}


def phase_lm_train(torch):
    """Training on one card at smollm-135m's full width (30 layers, d 576,
    9 over 3 heads, vocab 49,152, tied embeddings, bf16, flash on), seed-0
    weights from ``init_params``: ``train.loop.train`` for LM_TRAIN_STEPS
    AdamW steps of the synthetic pipeline's 8 x 256 tokens in 2
    microbatches, an ``AsyncSaver`` checkpoint at step LM_TRAIN_CKPT into a
    temporary
    directory (deleted at the end). Checks: every loss finite, none
    skipped, the mean of the last 10 at least LM_TRAIN_DROP nats below the
    first; rmsnorm launches 61 x 2 a step and flash 30 x 2 (tensor cores),
    each with one plain backward, and no plain forward; that checkpoint
    restores bit for bit, and a run resumed from it gives the straight
    run's loss at that step exactly and its next 9 within
    LM_TRAIN_RESUME_RTOL. Then gradients with the kernels against the
    plain versions at full width (float32: rmsnorm only, then flash on the
    CUDA-core body; bf16: the loss, flash on tensor cores), each kernel's
    gradient at the training shapes in both orders and on both bodies, and
    one profiled step."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch_fn
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as step_mod
    from repro_torch.train.loop import LoopConfig, train
    t_phase = time.perf_counter()
    mcfg = get_config("smollm-135m").replace(use_flash=True)
    dcfg = DataConfig(**LM_TRAIN_DATA)
    opt = OptConfig(**LM_TRAIN_OPT)
    L = mcfg.n_layers
    tokens_per_step = dcfg.global_batch * dcfg.seq_len
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_lm_train_")
    log: list[str] = []
    seconds = {}        # the phase's parts, host clock
    try:
        counters, plain = lm_train_counters()
        torch.cuda.reset_peak_memory_stats()
        with plain:
            t0 = time.perf_counter()
            out = train(mcfg, opt, dcfg, LoopConfig(
                steps=LM_TRAIN_STEPS, ckpt_dir=ckpt, ckpt_every=LM_TRAIN_CKPT,
                log_every=10, n_microbatches=LM_TRAIN_MICRO, seed=0),
                log=log.append, device="cuda")
            wall = time.perf_counter() - t0
        seconds["train"] = wall
        steps_per_s = out["steps_per_s"]
        counts = read_train_counters(counters, plain)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        hist = out["history"]
        losses = [h["loss"] for h in hist]
        check(len(hist) == LM_TRAIN_STEPS and all(np.isfinite(losses)),
              f"lm_train: {len(hist)} steps, losses {losses}")
        check(not any(h["skipped"] for h in hist), "lm_train: a step skipped")
        drop = losses[0] - float(np.mean(losses[-10:]))
        check(drop >= LM_TRAIN_DROP,
              f"lm_train: the loss fell {drop:.3f} nats ({losses[0]:.3f} -> "
              f"mean of the last 10 {np.mean(losses[-10:]):.3f})")
        micro = LM_TRAIN_STEPS * LM_TRAIN_MICRO
        check(counts["rmsnorm"] == {"launches": (2 * L + 1) * micro,
                                    "plain_backwards": (2 * L + 1) * micro,
                                    "plain_forwards": 0},
              f"lm_train: rmsnorm counts {counts['rmsnorm']}, expected "
              f"{2 * L + 1} x {LM_TRAIN_MICRO} a step and no plain forward")
        check(counts["flash_attention"] == {"launches": L * micro,
                                            "plain_backwards": L * micro,
                                            "plain_forwards": 0}
              and counts["flash_by_body"] == {"tensor_cores": L * micro,
                                              "cuda_cores": 0},
              f"lm_train: flash counts {counts}")
        launches = {"flash_attention": L * micro,
                    "rmsnorm": (2 * L + 1) * micro, "uct_select": 0}
        times = [h["time_s"] for h in hist]

        # the step-LM_TRAIN_CKPT checkpoint: bit for bit, then a resumed run
        t0 = time.perf_counter()
        ckpt_step = store.step_dir(ckpt, LM_TRAIN_CKPT)
        restored, extra = store.restore(ckpt, LM_TRAIN_CKPT,
                                        step_mod.abstract_state(mcfg),
                                        device="cuda")
        check(extra == {"data_step": LM_TRAIN_CKPT},
              f"lm_train: step-{LM_TRAIN_CKPT} extra {extra}")
        with np.load(os.path.join(ckpt_step, "arrays.npz")) as z:
            for key, t in store._flatten(restored).items():
                saved = torch.from_numpy(z[key]).to("cuda")
                check(torch.equal(t.to(saved.dtype), saved),
                      f"lm_train: restored {key} differs from the checkpoint")
        check(int(restored["opt"]["step"]) == LM_TRAIN_CKPT,
              "lm_train: restored step counter")
        del restored
        seconds["restore_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resume_dir = tempfile.mkdtemp(prefix="chip_smoke_lm_resume_")
        try:
            # the checkpoint's directory, linked (not copied) into a fresh one
            shutil.copytree(ckpt_step, store.step_dir(resume_dir, LM_TRAIN_CKPT),
                            copy_function=os.link)
            rlog: list[str] = []
            resumed = train(mcfg, opt, dcfg, LoopConfig(
                steps=LM_TRAIN_CKPT + LM_TRAIN_RESUME_STEPS,
                ckpt_dir=resume_dir, ckpt_every=LM_TRAIN_STEPS,
                log_every=LM_TRAIN_STEPS, n_microbatches=LM_TRAIN_MICRO),
                log=rlog.append, device="cuda")
        finally:
            shutil.rmtree(resume_dir, ignore_errors=True)
        rl = [h["loss"] for h in resumed["history"]]
        sl = losses[LM_TRAIN_CKPT:LM_TRAIN_CKPT + LM_TRAIN_RESUME_STEPS]
        check(rlog[0] == f"[resume] restored step {LM_TRAIN_CKPT}, data_step "
                         f"{LM_TRAIN_CKPT}" and len(rl) == len(sl),
              f"lm_train: resume {rlog[:1]}, {len(rl)} steps")
        check(rl[0] == sl[0], f"lm_train: resumed step-{LM_TRAIN_CKPT} loss "
                              f"{rl[0]} != "
                              f"the straight run's {sl[0]}")
        resume_err = max(abs(a - b) / abs(b) for a, b in zip(rl[1:], sl[1:]))
        check(resume_err <= LM_TRAIN_RESUME_RTOL,
              f"lm_train: resumed losses {rl} against {sl}")
        del resumed
        seconds["resume"] = time.perf_counter() - t0

        # one profiled step on the trained state
        t0 = time.perf_counter()
        state = out["state"]
        step_fn = step_mod.make_train_step(mcfg, opt, LM_TRAIN_MICRO)
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                 make_batch_fn(dcfg, mcfg)(LM_TRAIN_STEPS).items()}
        step_fn(state, batch)
        torch.cuda.synchronize()
        profiled = profile_one_train_step(torch, step_fn, state, batch)
        n_params = sum(p.numel() for _, p in tree_leaves(state["params"].tree()))
        del out, state
        torch.cuda.empty_cache()
        seconds["profiled_step"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()

    # gradients with the kernels against the plain versions, full width
    micro_batch = {k: torch.as_tensor(v[:dcfg.global_batch // LM_TRAIN_MICRO],
                                      device="cuda")
                   for k, v in make_batch_fn(dcfg, mcfg)(0).items()}
    f32 = mcfg.replace(param_dtype="float32", compute_dtype="float32")
    grads = {"float32_rmsnorm": grads_vs_plain(
                 torch, f32.replace(use_flash=False), micro_batch,
                 "float32 grads, rmsnorm"),
             "float32_flash": grads_vs_plain(
                 torch, f32, micro_batch, "float32 grads, rmsnorm + flash"),
             "bfloat16_loss": bf16_loss_vs_plain(torch, mcfg, micro_batch)}
    seconds["grads_vs_plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    at_shapes = kernel_grads_at_training_shapes(torch)
    seconds["kernel_grads"] = time.perf_counter() - t0
    step_ms = 1e3 * float(np.median(times[1:]))
    emit("lm_train",
         config={"model": "smollm-135m", "n_params": n_params,
                 "dtype": "bfloat16", "use_flash": True, **LM_TRAIN_DATA,
                 "n_microbatches": LM_TRAIN_MICRO, "steps": LM_TRAIN_STEPS,
                 "opt": LM_TRAIN_OPT, "ckpt_every": LM_TRAIN_CKPT,
                 "weights": "random, seed 0", "data": "synthetic Zipf, seed 17"},
         losses_every_10=losses[::10], loss_first=losses[0],
         loss_last10_mean=float(np.mean(losses[-10:])), loss_drop=drop,
         seconds_train=wall, steps_per_s=steps_per_s,
         ms_per_step_median=step_ms,
         tokens_per_s=tokens_per_step * steps_per_s,
         first_step_s=times[0], peak_memory_mb=peak_mb,
         launches=launches, counts=counts,
         per_step={"rmsnorm_launches": counts["rmsnorm"]["launches"]
                   // LM_TRAIN_STEPS,
                   "rmsnorm_plain_backwards":
                       counts["rmsnorm"]["plain_backwards"] // LM_TRAIN_STEPS,
                   "flash_launches": counts["flash_attention"]["launches"]
                   // LM_TRAIN_STEPS,
                   "flash_plain_backwards":
                       counts["flash_attention"]["plain_backwards"]
                       // LM_TRAIN_STEPS},
         resume={"step": LM_TRAIN_CKPT, "restored_bit_equal": True,
                 "first_loss_equal": True, "max_rel_err_next": resume_err,
                 "losses": rl},
         profiled_step=profiled, grads_vs_plain=grads,
         kernel_grads_at_training_shapes=at_shapes,
         log_tail=log[-3:], seconds=seconds,
         steps_seconds=sum(times), phase_seconds=time.perf_counter() - t_phase)
    return launches, counts["flash_by_body"]


def roofline_kernel_shapes():
    """The shapes the lm_roofline cells give the kernels: rmsnorm's (rows,
    D, cell) and flash attention's ((B, H, Hkv, S, d), cell)."""
    from repro_torch.configs import SHAPES, get_config
    norms, flashes = [], []
    for arch, shape_name, batch in ROOFLINE_CELLS:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        of = f"{arch} {shape_name}"
        rows = batch * (1 if shape.kind == "decode" else shape.seq_len)
        norms.append((rows, cfg.d_model, of))
        if shape.kind != "decode":
            flashes.append(((batch, cfg.n_heads, cfg.n_kv_heads,
                             shape.seq_len, cfg.hd), of))
    return norms, flashes


def roofline_inputs(torch, spec):
    """The card's arguments for a dry-run cell's step (``launch.inputs.
    input_specs``): seed-0 weights (a trainable state with zero moments for
    a train cell), seeded tokens, a zeroed cache of the cell's length; for
    a decode cell, one (B,) position tensor a step, near the cache's end
    (the attention reads every row whatever its value)."""
    from repro_torch.models import api
    from repro_torch.train import step as step_mod
    cfg, shape = spec["cfg"], spec["shape"]
    g = torch.Generator(device="cuda").manual_seed(23)
    B, S = shape.global_batch, shape.seq_len
    tokens = lambda *sh: torch.randint(0, cfg.vocab, sh, generator=g,
                                       device="cuda", dtype=torch.int32)
    if shape.kind == "train":
        state = step_mod.make_state(cfg, 0, spec["moment_dtype"], "cuda")
        batch = {"tokens": tokens(B, S), "labels": tokens(B, S),
                 "mask": torch.ones(B, S, device="cuda")}
        return [(state, batch)] * (1 + ROOFLINE_STEPS)
    params = api.init_params(cfg, 0, "cuda")
    if shape.kind == "prefill":
        return [(params, {"tokens": tokens(B, S)})] * (1 + ROOFLINE_STEPS)
    cache = api.init_cache(cfg, B, S, device="cuda")
    return [(params, tokens(B, 1),
             torch.full((B,), S - 1 - ROOFLINE_STEPS + i, dtype=torch.int32,
                        device="cuda"), cache)
            for i in range(1 + ROOFLINE_STEPS)]


def phase_lm_roofline(torch):
    """Three cells of the dry-run at published widths measured against
    their roofline (ROOFLINE_CELLS: smollm-135m train_4k, qwen1.5-0.5b
    prefill_32k, llama3-8b decode_32k; bf16, flash on, ``tune_for_shape``'s
    knobs, only the global batch cut). Each cell is first counted on
    ``meta`` by the port's own dry-run (``launch.dryrun.analyze_cell``:
    FLOPs, bytes, the roofline terms with the H100's peaks, the peak of
    live storages, the kernel calls), then run on the card: 1 warm step and
    ROOFLINE_STEPS timed ones (host clock around synchronised steps; the
    median). Checks: no step shorter than its compute term or than reading
    its arguments and writing its outputs once at the memory rate; the
    dry-run's peak within ROOFLINE_PEAK_RATIO of the card's (above the
    memory held before the cell); each kernel launched as often as the
    dry-run called it, every step, and its backward through the plain
    version as often (flash on the tensor cores; rmsnorm in every cell,
    flash in train and prefill)."""
    import statistics

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    cells, total, bodies = [], {}, {}
    for arch, shape_name, batch in ROOFLINE_CELLS:
        t0 = time.perf_counter()
        cut = {"global_batch": batch}
        res = dryrun.analyze_cell(arch, shape_name,
                                  cfg_overrides={"use_flash": True},
                                  shape_overrides=cut)
        count_s = time.perf_counter() - t0
        step, _, spec = dryrun.build_cell(arch, shape_name,
                                          {"use_flash": True}, cut)
        shape, r, mem = spec["shape"], res["roofline"], res["memory"]
        calls = res["kernels"]["calls"]
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        steps_args = roofline_inputs(torch, spec)
        counters, plain = lm_train_counters()
        torch.cuda.reset_peak_memory_stats()
        times = []
        with plain, torch.set_grad_enabled(shape.kind == "train"):
            for args in steps_args:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                del out
        peak = torch.cuda.max_memory_allocated() - base
        counts = read_train_counters(counters, plain)
        del steps_args, args
        torch.cuda.empty_cache()
        n = 1 + ROOFLINE_STEPS
        launches = {k: counts[k]["launches"] for k in calls}
        backwards = {k: counts[k]["plain_backwards"] for k in calls}
        check(launches == {k: n * c for k, c in calls.items()}
              and backwards == {k: n * c for k, c in
                                res["kernels"]["plain_backwards"].items()}
              and counts["flash_by_body"]["cuda_cores"] == 0,
              f"lm_roofline {arch} {shape_name}: launches {counts} over {n} "
              f"steps, the dry-run's calls {res['kernels']} a step")
        check(calls["rmsnorm"] > 0 and (calls["flash_attention"] > 0)
              == (shape.kind != "decode"),
              f"lm_roofline {arch} {shape_name}: kernel calls {calls}")
        check(all(counts[k]["plain_forwards"] == 0 for k in calls),
              f"lm_roofline {arch} {shape_name}: a plain forward ran")
        measured = statistics.median(times[1:])
        compute_s, memory_s = r["compute_s"], r["memory_s"]
        io_s = (mem["argument_bytes"] + mem["output_bytes"]) / HBM_BYTES_PER_S
        check(min(times[1:]) >= max(compute_s, io_s),
              f"lm_roofline {arch} {shape_name}: a step of {min(times[1:])} s "
              f"under its compute term {compute_s} s or its argument and "
              f"output bytes' {io_s} s")
        est = mem["peak_bytes_per_chip"]
        lo, hi = ROOFLINE_PEAK_RATIO
        check(lo <= est / peak <= hi,
              f"lm_roofline {arch} {shape_name}: the dry-run's peak {est} B "
              f"against the card's {peak} B")
        total = add_counts(total, launches)
        bodies = add_counts(bodies, counts["flash_by_body"])
        cells.append({
            "arch": arch, "shape": shape_name, "kind": shape.kind,
            "seq_len": shape.seq_len, "global_batch": batch,
            "reduced": {"global_batch": [SHAPES[shape_name].global_batch,
                                         batch]},
            "config": {k: getattr(spec["cfg"], k) for k in (
                "param_dtype", "use_flash", "remat", "logits_chunk",
                "attn_chunk")},
            "n_microbatches": spec.get("n_microbatches"),
            "n_params": res["n_params"],
            "flops": r["flops_per_chip"],
            "matmul_flops": res["cost"]["matmul_flops"],
            "bytes": res["cost"]["parsed_bytes_upper_bound"],
            "bytes_major": r["hbm_bytes_per_chip"],
            "model_flops": r["model_flops_global"],
            "attn_flops": r["attn_flops_global"],
            "compute_ms": 1e3 * compute_s, "memory_ms": 1e3 * memory_s,
            "roofline_ms": 1e3 * r["step_time_s"],
            "bottleneck": r["bottleneck"],
            "io_ms": 1e3 * io_s,
            "measured_ms": 1e3 * measured,
            "steps_ms": [1e3 * t for t in times],
            "roofline_share": r["step_time_s"] / measured,
            "mfu": r["model_flops_global"] / (BF16_TENSOR_OPS_PER_S
                                              * measured),
            "peak_estimate_mb": est / 2**20, "peak_measured_mb": peak / 2**20,
            "peak_ratio": est / peak,
            "launches": launches, "launches_a_step": calls,
            "plain_backwards": backwards,
            "dryrun_count_s": count_s})
    emit("lm_roofline", cells=cells,
         peaks={"bf16_flops_per_s": BF16_TENSOR_OPS_PER_S,
                "hbm_bytes_per_s": HBM_BYTES_PER_S},
         phase_seconds=time.perf_counter() - t_phase)
    return total, bodies


def sharded_inputs(torch, spec, mesh):
    """The cell's arguments as rank 0's shards on the card, each block made
    directly (the whole tensor never exists): seed-0 weights (a generator a
    leaf, drawn in float32 at 0.02 and cast), a zeroed cache, seeded tokens,
    and one (B,) position tensor a step near the cache's end. The position
    and token shards are the inputs' own, never a collective's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import inputs as inp
    from repro_torch.sharding import rules as shr

    cfg, shape, rules = spec["cfg"], spec["shape"], spec["rules"]
    B, S = shape.global_batch, shape.seq_len
    seed = iter(range(1 << 20))

    def weight(local_shape, dtype):
        g = torch.Generator(device="cuda").manual_seed(next(seed))
        return (0.02 * torch.randn(local_shape, generator=g, device="cuda")
                ).to(dtype)

    def zeros(local_shape, dtype):
        return torch.zeros(local_shape, dtype=dtype, device="cuda")

    params = inp.place_tree(mesh, spec["params"], spec["param_axes"], rules,
                            init=weight)
    cache = inp.place_tree(mesh, spec["cache"], spec["cache_axes"], rules,
                           init=zeros)
    g = torch.Generator(device="cuda").manual_seed(23)
    steps = []
    for i in range(1 + LM_SHARDED_STEPS):
        tok = shr.distribute_to(mesh, spec["tokens"], ("batch", None), rules,
                                init=lambda sh, dt: torch.randint(
                                    0, cfg.vocab, sh, generator=g,
                                    device="cuda", dtype=dt))
        pos = shr.distribute_to(mesh, spec["pos"], ("batch",), rules,
                                init=lambda sh, dt, i=i: torch.full(
                                    sh, S - 1 - LM_SHARDED_STEPS + i,
                                    dtype=dt, device="cuda"))
        steps.append((tok, pos))
    check(all(isinstance(t, DTensor) and t.to_local().is_cuda
              for t in (params["final_norm"], tok, pos)),
          "lm_sharded: the inputs are not shards on the card")
    return params, cache, steps


def phase_lm_sharded(torch):
    """One rank's share of two full-width decode cells on the single-pod
    (16, 16) mesh (LM_SHARDED_CELLS x decode_32k, bf16, every layer:
    qwen3-moe-235b-a22b's 94 are ~470 GB, which no card holds whole). This
    process is rank 0 of a ``"fake"`` process group of 256 ranks: its
    collectives return at once and write nothing, so what runs is rank 0's
    own work, its shards and the collectives' buffers. Each cell is counted
    by the sharded dry-run on ``meta`` (``launch.dryrun.analyze_cell``,
    mesh ``single``: per-rank FLOPs, bytes, wire bytes, collectives, peak,
    kernel calls), then rank 0's shards are made directly on the card
    (``sharded_inputs``) and 1 warm and LM_SHARDED_STEPS timed decode steps
    run under DTensor, and one more under the profiler (its idle share).
    Checks: rmsnorm launched as often as the count's calls, every step; no
    step shorter than the rank's compute term or than moving its arguments
    and outputs once; the count's peak within LM_SHARDED_PEAK_RATIO of the
    card's. Values are not checked: a fake collective's output is
    uninitialized memory."""
    import statistics

    from torch.distributed.tensor.experimental import implicit_replication
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun
    from repro_torch.launch import inputs as inp
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import api
    from repro_torch.sharding import rules as shr
    t_phase = time.perf_counter()
    cells, total = [], {}
    with lmesh.fake_process_group(256):
        count_mesh = lmesh.make_production_mesh()
        mesh = lmesh.make_production_mesh(device_type="cuda")
        for arch in LM_SHARDED_CELLS:
            t0 = time.perf_counter()
            res = dryrun.analyze_cell(arch, LM_SHARDED_SHAPE, "single",
                                      mesh=count_mesh)
            count_s = time.perf_counter() - t0
            spec = inp.input_specs(arch, LM_SHARDED_SHAPE,
                                   {"use_flash": False})
            cfg = spec["cfg"]
            r, mem = res["roofline"], res["memory"]
            calls = res["kernels"]["calls"]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            params, cache, steps = sharded_inputs(torch, spec, mesh)
            counters, plain = lm_train_counters()
            times = []
            with shr.use_rules(spec["rules"], mesh), implicit_replication(), \
                    plain, torch.no_grad():
                for tok, pos in steps:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = api.decode(params, cfg, tok, pos, cache)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    del out
                peak = torch.cuda.max_memory_allocated() - base
                counts = read_train_counters(counters, plain)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    api.decode(params, cfg, *steps[-1], cache)
                    torch.cuda.synchronize()
                    wall_ms = 1e3 * (time.perf_counter() - t0)
            kernels, device_ms = cuda_activity(prof)
            del params, cache, steps
            torch.cuda.empty_cache()
            n = 1 + LM_SHARDED_STEPS
            launches = {k: counts[k]["launches"] for k in calls}
            check(calls["rmsnorm"] > 0
                  and launches == {k: n * c for k, c in calls.items()}
                  and all(counts[k]["plain_forwards"] == 0 for k in calls),
                  f"lm_sharded {arch}: launches {counts} over {n} steps, the "
                  f"count's calls {calls} a step")
            measured = statistics.median(times[1:])
            io_s = (mem["argument_bytes"] + mem["output_bytes"]) \
                / HBM_BYTES_PER_S
            check(min(times[1:]) >= max(r["compute_s"], io_s),
                  f"lm_sharded {arch}: a step of {min(times[1:])} s under "
                  f"the rank's compute term {r['compute_s']} s or its "
                  f"argument and output bytes' {io_s} s")
            est = mem["peak_bytes_per_chip"]
            lo, hi = LM_SHARDED_PEAK_RATIO
            check(lo <= est / peak <= hi,
                  f"lm_sharded {arch}: the count's peak {est} B against the "
                  f"card's {peak} B")
            total = add_counts(total, launches)
            coll = res["collectives"]
            cells.append({
                "arch": arch, "shape": LM_SHARDED_SHAPE,
                "mesh": res["mesh_dims"], "rank": 0,
                "n_params": res["n_params"], "n_layers": cfg.n_layers,
                "global_batch": spec["shape"].global_batch,
                "seq_len": spec["shape"].seq_len,
                "flops_per_rank": r["flops_per_chip"],
                "matmul_flops_per_rank": res["cost"]["matmul_flops"],
                "bytes_per_rank": r["hbm_bytes_per_chip"],
                "wire_bytes_per_rank": r["wire_bytes_per_chip"],
                "collectives": {op: c for op, (c, _) in
                                coll["by_op"].items()},
                "collective_count": coll["count"],
                "compute_ms": 1e3 * r["compute_s"],
                "memory_ms": 1e3 * r["memory_s"],
                "collective_ms": 1e3 * r["collective_s"],
                "io_ms": 1e3 * io_s,
                "measured_ms": 1e3 * measured,
                "steps_ms": [1e3 * t for t in times],
                "profiled_step": {"cuda_kernels": kernels,
                                  "device_ms": device_ms, "wall_ms": wall_ms,
                                  "device_idle_share": None if device_ms is
                                  None else 1 - device_ms / wall_ms},
                "peak_count_mb": est / 2**20, "peak_measured_mb": peak / 2**20,
                "peak_ratio": est / peak,
                "argument_mb": mem["argument_bytes"] / 2**20,
                "launches": launches, "launches_a_step": calls,
                "count_s": count_s})
    emit("lm_sharded", cells=cells, phase_seconds=time.perf_counter() - t_phase)
    return total



def mesh_train_on_one_rank(torch) -> dict:
    """Part (a) of ``lm_sharded_train``: a real process group of this
    process alone (nccl) and its (1, 1) ("data", "model") ``DeviceMesh``
    on the card. ``train.loop.train(mesh=)`` trains the reduced smollm-135m
    twin (float32, flash off) for LM_MESH_TRAIN_STEPS steps with every leaf
    a DTensor, and its losses must equal the unsharded loop's on the card
    (same seed, same batches) within LM_MESH_TRAIN_RTOL; one step through
    ``jit_train_step`` with the kernels (rmsnorm under autograd inside
    ``local_region``: launches, one plain backward each, no plain forward)
    against the same step under ``ops.plain_versions()`` on the same
    weights, the loss within LM_TRAIN_GRAD_LOSS_RTOL; and the int8
    quantization of a 1e7-element float32 gradient on the card equal to the
    CPU's bit for bit. Returns the record and the rmsnorm launches."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_batch_fn
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.optim import compression as comp
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as step_mod
    from repro_torch.train.loop import LoopConfig, train
    cfg = configs.reduced_config("smollm-135m")
    dcfg = DataConfig(**LM_MESH_TRAIN_DATA)
    opt = OptConfig(**LM_MESH_TRAIN_OPT)
    loop = LoopConfig(steps=LM_MESH_TRAIN_STEPS, log_every=1)
    out = {}
    with lmesh.process_group("cuda"):
        mesh = lmesh.make_group_mesh("cuda")
        check(lmesh.mesh_dims(mesh) == {"data": 1, "model": 1},
              f"lm_sharded_train: a group of one gives {mesh}")
        counters, plain = lm_train_counters()
        with plain:
            t0 = time.perf_counter()
            sharded = train(cfg, opt, dcfg, loop, mesh=mesh,
                            log=lambda line: None, device="cuda")
            out["mesh_seconds"] = time.perf_counter() - t0
        counts = read_train_counters(counters, plain)
        check(all(isinstance(t, DTensor) and t.to_local().is_cuda
                  for t in (sharded["state"]["params"].tree()["final_norm"],
                            sharded["state"]["opt"]["step"])),
              "lm_sharded_train: the mesh run's state is not on the mesh")
        t0 = time.perf_counter()
        unsharded = train(cfg, opt, dcfg, loop, log=lambda line: None,
                          device="cuda")
        out["unsharded_seconds"] = time.perf_counter() - t0
        got = [h["loss"] for h in sharded["history"]]
        want = [h["loss"] for h in unsharded["history"]]
        err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        check(len(got) == LM_MESH_TRAIN_STEPS and err <= LM_MESH_TRAIN_RTOL,
              f"lm_sharded_train: mesh losses {got}, unsharded {want}")
        norms = 2 * cfg.n_layers + 1
        check(counts["rmsnorm"] == {
            "launches": norms * LM_MESH_TRAIN_STEPS,
            "plain_backwards": norms * LM_MESH_TRAIN_STEPS,
            "plain_forwards": 0},
              f"lm_sharded_train: the mesh run's rmsnorm counts {counts}")
        out.update(losses=got, unsharded_losses=want, max_rel_err=err,
                   counts=counts)
        launches = counts["rmsnorm"]["launches"]

        # one step, the kernels against the plain versions, same weights
        state = step_mod.make_state(cfg, 1, device="cuda")
        batch = make_batch_fn(dcfg, cfg)(0)
        step = step_mod.jit_train_step(step_mod.make_train_step(cfg, opt),
                                       mesh, cfg, batch, donate=False)
        counters, plain = lm_train_counters()
        with plain:
            _, m_k = step(state, batch)
            loss_k = float(m_k["loss"])
        step_counts = read_train_counters(counters, plain)
        with ops.plain_versions():
            loss_p = float(step(state, batch)[1]["loss"])
        launches += step_counts["rmsnorm"]["launches"]
        check(step_counts["rmsnorm"] == {"launches": norms,
                                         "plain_backwards": norms,
                                         "plain_forwards": 0},
              f"lm_sharded_train: kernel step counts {step_counts}")
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        check(loss_err <= LM_TRAIN_GRAD_LOSS_RTOL,
              f"lm_sharded_train: the mesh step's loss {loss_k} with the "
              f"kernels, {loss_p} plain")
        out["kernels_vs_plain"] = {"loss": loss_k, "loss_plain": loss_p,
                                   "rel_err": loss_err,
                                   "counts": step_counts}

    g = torch.Generator(device="cuda").manual_seed(31)
    grad = torch.randn(LM_QUANT_ELEMENTS, generator=g, device="cuda") \
        * torch.logspace(-6, 2, LM_QUANT_ELEMENTS, device="cuda")
    q, scale = comp.quantize_int8(grad)
    back = comp.dequantize_int8(q, scale, grad.shape, torch.float32)
    q_cpu, scale_cpu = comp.quantize_int8(grad.cpu())
    back_cpu = comp.dequantize_int8(q_cpu, scale_cpu, grad.shape,
                                    torch.float32)
    check(torch.equal(q.cpu(), q_cpu) and torch.equal(scale.cpu(), scale_cpu)
          and torch.equal(back.cpu(), back_cpu),
          "lm_sharded_train: int8 quantization on the card differs from the "
          "CPU's")
    out["quantize"] = {"elements": LM_QUANT_ELEMENTS, "bit_equal_cpu": True,
                       "max_rel_err": float(((back - grad).abs().max())
                                            / grad.abs().max())}
    return out, launches


def sharded_train_inputs(torch, spec, mesh):
    """Rank 0's blocks of the train cell's state and batch, each made
    directly on the card (the whole tensor never exists): seed-0 weights
    (a generator a leaf, float32 at 0.02, cast), zero moments and step,
    seeded tokens and labels, a mask of ones."""
    from repro_torch.launch import inputs as inp
    from repro_torch.train import step as step_mod

    cfg, rules = spec["cfg"], spec["rules"]
    seed = iter(range(1 << 20))

    def weight(local_shape, dtype):
        g = torch.Generator(device="cuda").manual_seed(next(seed))
        return (0.02 * torch.randn(local_shape, generator=g, device="cuda")
                ).to(dtype)

    def zeros(local_shape, dtype):
        return torch.zeros(local_shape, dtype=dtype, device="cuda")

    abstract = step_mod.abstract_state(cfg, spec["moment_dtype"])
    axes = spec["state_axes"]
    state = {"params": inp.place_tree(mesh, abstract["params"],
                                      axes["params"], rules, init=weight),
             "opt": inp.place_tree(mesh, abstract["opt"], axes["opt"], rules,
                                   init=zeros)}
    g = torch.Generator(device="cuda").manual_seed(29)

    def tokens(local_shape, dtype):
        return torch.randint(0, cfg.vocab, local_shape, generator=g,
                             device="cuda", dtype=dtype)

    meta = spec["batch"]
    batch = {k: inp.place_tree(mesh, {k: meta[k]}, None, rules,
                               init=zeros if k == "mask" else tokens)[k]
             for k in ("tokens", "labels", "mask")}
    batch["mask"].to_local().fill_(1.0)
    return step_mod.trainable_state(cfg, state), batch


def phase_lm_sharded_train(torch):
    """Training on a mesh: part (a) ``mesh_train_on_one_rank`` (real
    values on a real group of one rank), then part (b), one rank's share
    of a full-width train step on the single-pod (16, 16) mesh. This
    process is rank 0 of a ``"fake"`` process group of 256 ranks, whose
    collectives move nothing; the cell is llama3-8b x train_4k (32 layers,
    bf16 params, float32 moments, 4 microbatches of 64 x 4,096 tokens, flash
    off, as the sharded dry-run counts it). It is counted first by
    ``launch.dryrun.analyze_cell`` on ``meta``; ``train.step.
    state_shardings`` — the reference's, which keeps an axis that does not
    divide — must refuse this cell (8 kv heads over 16), so rank 0's state
    and batch blocks are made directly on the card by the dry-run's own
    divisibility-aware placements (``sharded_train_inputs``); 1 warm and
    LM_SHARDED_TRAIN_STEPS timed steps run through ``jit_train_step``, and
    one more under the profiler. Checks: rmsnorm launched and
    backward as often as the count calls them, every step, and no plain
    forward; the count's peak within LM_SHARDED_PEAK_RATIO of the card's;
    no step shorter than the rank's compute term or than moving its
    arguments and outputs once. Values are not checked (a fake collective
    writes nothing; AdamW's skip is a ``torch.where``, so the work does not
    depend on them)."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun
    from repro_torch.launch import inputs as inp
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models.common import torch_dtype
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as step_mod
    t_phase = time.perf_counter()
    one_rank, launches_a = mesh_train_on_one_rank(torch)
    one_rank["seconds"] = time.perf_counter() - t_phase
    arch, shape_name = LM_SHARDED_TRAIN_CELL
    with lmesh.fake_process_group(256):
        count_mesh = lmesh.make_production_mesh()
        mesh = lmesh.make_production_mesh(device_type="cuda")
        t0 = time.perf_counter()
        res = dryrun.analyze_cell(arch, shape_name, "single",
                                  mesh=count_mesh)
        count_s = time.perf_counter() - t0
        spec = inp.input_specs(arch, shape_name, {"use_flash": False})
        cfg = spec["cfg"]
        try:
            step_mod.state_shardings(mesh, cfg, spec["rules"])
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "attn.wk dimension 2 of size 8" in refused,
              f"lm_sharded_train: state_shardings on (16, 16): {refused}")
        r, mem = res["roofline"], res["memory"]
        calls = res["kernels"]["calls"]
        backwards = res["kernels"]["plain_backwards"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, batch = sharded_train_inputs(torch, spec, mesh)
        step = step_mod.jit_train_step(
            step_mod.make_train_step(
                cfg, OptConfig(moment_dtype=spec["moment_dtype"]),
                spec["n_microbatches"], torch_dtype(spec["accum_dtype"])),
            mesh, cfg, spec["batch"], spec["rules"])
        counters, plain = lm_train_counters()
        times = []
        with plain:
            for _ in range(1 + LM_SHARDED_TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            del metrics
        peak = torch.cuda.max_memory_allocated() - base
        counts = read_train_counters(counters, plain)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels, device_ms = cuda_activity(prof)
        del state, batch, step, prof
        torch.cuda.empty_cache()
    n = 1 + LM_SHARDED_TRAIN_STEPS
    check(calls["rmsnorm"] > 0 and calls["flash_attention"] == 0
          and counts["rmsnorm"] == {"launches": n * calls["rmsnorm"],
                                    "plain_backwards": n * backwards["rmsnorm"],
                                    "plain_forwards": 0}
          and counts["flash_attention"]["launches"] == 0,
          f"lm_sharded_train: counts {counts} over {n} steps, the count's "
          f"calls {calls} and backwards {backwards} a step")
    io_s = (mem["argument_bytes"] + mem["output_bytes"]) / HBM_BYTES_PER_S
    check(min(times[1:]) >= max(r["compute_s"], io_s),
          f"lm_sharded_train: a step of {min(times[1:])} s under the rank's "
          f"compute term {r['compute_s']} s or its argument and output "
          f"bytes' {io_s} s")
    est = mem["peak_bytes_per_chip"]
    lo, hi = LM_SHARDED_PEAK_RATIO
    check(lo <= est / peak <= hi,
          f"lm_sharded_train: the count's peak {est} B against the card's "
          f"{peak} B")
    measured = statistics.median(times[1:])
    coll = res["collectives"]
    cell = {
        "arch": arch, "shape": shape_name, "mesh": res["mesh_dims"],
        "rank": 0, "n_params": res["n_params"], "n_layers": cfg.n_layers,
        "global_batch": spec["shape"].global_batch,
        "seq_len": spec["shape"].seq_len,
        "n_microbatches": spec["n_microbatches"],
        "moment_dtype": spec["moment_dtype"],
        "state_shardings_refused": refused,
        "flops_per_rank": r["flops_per_chip"],
        "matmul_flops_per_rank": res["cost"]["matmul_flops"],
        "bytes_per_rank": r["hbm_bytes_per_chip"],
        "wire_bytes_per_rank": r["wire_bytes_per_chip"],
        "collectives": {op: c for op, (c, _) in coll["by_op"].items()},
        "collective_count": coll["count"],
        "compute_ms": 1e3 * r["compute_s"], "memory_ms": 1e3 * r["memory_s"],
        "collective_ms": 1e3 * r["collective_s"], "io_ms": 1e3 * io_s,
        "measured_ms": 1e3 * measured, "steps_ms": [1e3 * t for t in times],
        "tokens_per_s_rank": spec["shape"].global_batch
        * spec["shape"].seq_len / 256 / measured,
        "profiled_step": {"cuda_kernels": kernels, "device_ms": device_ms,
                          "wall_ms": wall_ms,
                          "device_idle_share": None if device_ms is None
                          else 1 - device_ms / wall_ms},
        "peak_count_mb": est / 2**20, "peak_measured_mb": peak / 2**20,
        "peak_ratio": est / peak,
        "argument_mb": mem["argument_bytes"] / 2**20,
        "launches": counts["rmsnorm"]["launches"],
        "rmsnorm_calls_a_step": calls["rmsnorm"],
        "rmsnorm_backwards_a_step": backwards["rmsnorm"], "count_s": count_s}
    emit("lm_sharded_train", one_rank=one_rank, cell=cell,
         phase_seconds=time.perf_counter() - t_phase)
    return {"rmsnorm": launches_a + counts["rmsnorm"]["launches"],
            "flash_attention": 0, "uct_select": 0}

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--playouts", type=int, default=PAPER_PLAYOUTS,
                   help="budget of the full-width search")
    p.add_argument("--sequential-playouts", type=int, default=1024,
                   help="budget of the scalar sequential search (2,048 "
                        "until lm_sharded_train needed the time)")
    p.add_argument("--only-kernels", action="store_true",
                   help="stop after the build and the kernel checks")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script measures the port on "
              "a GPU and does not fall back to the CPU", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    smi = phase_env(torch)
    phase_build()
    phase_rng(torch)
    records = phase_kernels(torch)
    lm_records, uct_lm_shapes = phase_lm_kernels(torch)
    next(r for r in records if r["name"] == "uct_select")["new_shapes"] = \
        uct_lm_shapes
    records += lm_records
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
    sharded_launches = phase_hex_forest_sharded(torch)
    gomoku_launches, gomoku_rate = phase_gomoku(torch)
    serve_launches, serve_rate = phase_serve_games(torch)
    model = lm_model(torch)
    lm_launches, flash_by_body = phase_lm_search(torch, model)
    batch_launches, batch_bodies = phase_lm_batch(torch, model)
    lm_serve_launches, serve_bodies = phase_lm_serve(torch, model)
    mcts_serve_launches, mcts_bodies = phase_lm_mcts_serve(torch, model)
    del model
    families_launches, families_bodies = phase_lm_families(torch)
    ve_launches, ve_bodies = phase_lm_vlm_encdec(torch)
    train_launches, train_bodies = phase_lm_train(torch)
    roofline_launches, roofline_bodies = phase_lm_roofline(torch)
    sharded_lm_launches = phase_lm_sharded(torch)
    sharded_train_launches = phase_lm_sharded_train(torch)
    flash_by_body = add_counts(flash_by_body, batch_bodies, serve_bodies,
                               mcts_bodies, families_bodies, ve_bodies,
                               train_bodies, roofline_bodies)
    for r in records:
        # each kernel's count on the paths it serves, each path's counters
        # zeroed just before it ran: select_descent, propose_move and
        # hex_playout on the Hex search, the paper's sweep, the Hex forest
        # (one device, then sharded: once a shard a sync iteration) and
        # game serving; select_descent and propose_move on Gomoku (its
        # playout has no kernel); uct_select
        # (the LM descent's tile), flash_attention and rmsnorm on the LM
        # search, the batched search, the LM engines, the families, the
        # vlm and encdec models, training and the roofline cells (flash and
        # rmsnorm: the forward's launches), rmsnorm on one rank's share of
        # the sharded decode cells and on training on a mesh (a group of
        # one rank, then one rank's share of a train cell); hex_winner
        # judges filled boards, which no path asks for
        by_path = {"hex_search": launches.get(r["name"], 0),
                   "paper_sweep": sweep_launches.get(r["name"], 0),
                   "hex_forest": forest_launches.get(r["name"], 0),
                   "hex_forest_sharded": sharded_launches.get(r["name"], 0),
                   "gomoku": gomoku_launches.get(r["name"], 0),
                   "serve_games": serve_launches.get(r["name"], 0),
                   "lm_search": lm_launches.get(r["name"], 0),
                   "lm_batch": batch_launches.get(r["name"], 0),
                   "lm_serve": lm_serve_launches.get(r["name"], 0),
                   "lm_mcts_serve": mcts_serve_launches.get(r["name"], 0),
                   "lm_families": families_launches.get(r["name"], 0),
                   "lm_vlm_encdec": ve_launches.get(r["name"], 0),
                   "lm_train": train_launches.get(r["name"], 0),
                   "lm_roofline": roofline_launches.get(r["name"], 0),
                   "lm_sharded": sharded_lm_launches.get(r["name"], 0),
                   "lm_sharded_train":
                       sharded_train_launches.get(r["name"], 0)}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        for body, body_record in r.get("bodies", {}).items():
            body_record["launches"] = flash_by_body[body]   # the LM paths'
    emit("summary", seconds=round(time.perf_counter() - t0, 1),
         search_playouts_per_s=rate, sequential_playouts_per_s=seq_rate,
         forest_playouts_per_s=forest_rate, gomoku_playouts_per_s=gomoku_rate,
         serve_playouts_per_s=serve_rate)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
