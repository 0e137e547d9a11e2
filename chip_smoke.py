#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc``, holds each against its plain PyTorch version on the card,
drives the port's main path — one full-width GSCPM Hex search (11x11, 256
lanes, the paper's 1,048,576 playouts) through
``repro_torch.core.gscpm.gscpm_search`` — and checks the result, including
that the same search run twice (at 65,536 playouts) gives bit-identical
trees. Each phase prints one JSON line; any failed check ends the run with a
non-zero exit code. Without a GPU it exits non-zero and prints no result.

The last line is ``{"ok": true, "device": {...}}``; the line before it has
the card's name and power limit; the line before that is the
``{"kernels": [...]}`` record with every kernel's time, bound and launches
on the main path.
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

# the paper's configuration: 11x11 Hex, 256 lanes, 1024 tasks, fifo, Cp = 1
FULL = dict(board_size=11, n_workers=256, n_tasks=1024, tree_cap=1 << 18,
            scheduler="fifo", cp=1.0, vl_rounds=1)
# the paper's budget; 65,536 playouts with tree_cap 1 << 18 is the cut-down
# run (`--playouts 65536`) for when the time limit is short
PAPER_PLAYOUTS = 1_048_576
SHORT_PLAYOUTS = 65_536


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
    emit("rng", ok=True, pinned=["fold_in", "split", "uniform"],
         card_equals_cpu=True, argmax_first_index=True)


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
    records = phase_kernels(torch)
    if args.only_kernels:
        for r in records:
            r["launches"] = 0
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    launches, rate = phase_search(torch, args.playouts)
    seq_rate = phase_sequential(torch, args.sequential_playouts)
    for r in records:
        r["launches"] = launches[r["name"]]
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
