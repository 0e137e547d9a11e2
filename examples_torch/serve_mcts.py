"""Serving end to end: batched requests and GSCPM-guided decoding, on the
port.

The torch twin of ``examples/serve_mcts.py``, on ``reduced_config(
"smollm-135m")`` with random weights from seed 0:

- part 1 serves a batch of prompts through the continuous-batching slot
  engine (``SlotEngine``: one decode step a tick, slots refilled from the
  queue);
- part 2 decodes with Grain-Size Controlled MCTS (``mcts_decode_search``)
  and shows the grain dial: the same playout budget at different nTasks;
- part 3 serves several search-guided requests at once: the MCTS slot
  engine gives every request its own token tree and advances them all as
  one forest (``MCTSSlotEngine``);
- part 4 swaps the lockstep pool for the TPFIFO work-sharing queue
  (``TPFIFOEngine``): grain-sized quanta, chunked prefill, preemption and
  per-request queue telemetry.

On the GPU the model runs in bfloat16, the full model's dtype, so the card
runs the tensor-core flash attention body and the bf16 rmsnorm kernel (the
reduced model's head dim, 32, has a tensor-core instance); ``--device cpu``
runs float32, as the JAX example does, through the kernels' plain PyTorch
versions.

    python examples_torch/serve_mcts.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs, rng  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serve.engine import MCTSSlotEngine, Request, SlotEngine  # noqa: E402
from repro_torch.serve.mcts_decode import (MCTSDecodeConfig,  # noqa: E402
                                           mcts_decode_search)
from repro_torch.serve.tpfifo import TPFIFOEngine  # noqa: E402

ARCH = "smollm-135m"
SWEEP_TASKS = (4, 16, 64)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    dev = torch.device(p.parse_args(argv).device)
    dtype = "bfloat16" if dev.type == "cuda" else "float32"
    cfg = configs.reduced_config(ARCH).replace(param_dtype=dtype,
                                               compute_dtype=dtype)
    params = api.init_params(cfg, seed=0, device=dev)
    draw = np.random.default_rng(0)

    # ---- part 1: continuous-batched greedy serving --------------------
    eng = SlotEngine(params, cfg, n_slots=4, max_len=64, device=dev)
    for rid in range(8):
        plen = int(draw.integers(4, 12))
        eng.submit(Request(rid=rid, prompt=draw.integers(
            1, cfg.vocab, size=(plen,)).astype(np.int32), max_new=12))
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in done)
    print(f"slot engine: {len(done)} requests, {tok} tokens, "
          f"{tok/dt:.1f} tok/s (4 slots, one decode step a tick)")
    out = {"slot": done}

    # ---- part 2: GSCPM decoding, sweeping the grain dial --------------
    prompt = torch.tensor(draw.integers(1, cfg.vocab, size=(12,)),
                          dtype=torch.int32, device=dev)
    out["grain"] = []
    for n_tasks in SWEEP_TASKS:
        dcfg = MCTSDecodeConfig(n_playouts=64, n_tasks=n_tasks, n_workers=4,
                                branch=6, max_depth=4, rollout_len=6)
        _, st = mcts_decode_search(params, cfg, prompt, dcfg,
                                   rng.key(1, dev), device=dev)
        print(f"GSCPM nTasks={n_tasks:3d} grain m={st['grain']:3d}: "
              f"{st['playouts']} playouts -> tree {st['tree_nodes']:4d} "
              f"nodes, best token {st['best_token']} "
              f"({st['playouts_per_s']:.0f} playouts/s)")
        out["grain"].append(st)

    # ---- part 3: multi-user MCTS serving (one tree per request) -------
    dcfg = MCTSDecodeConfig(n_playouts=32, n_tasks=8, n_workers=4,
                            branch=4, max_depth=3, rollout_len=4,
                            tree_cap=256)
    meng = MCTSSlotEngine(params, cfg, dcfg, n_slots=3, max_prompt_len=32,
                          device=dev)
    for rid in range(5):
        plen = int(draw.integers(4, 10))
        meng.submit(Request(rid=rid, prompt=draw.integers(
            1, cfg.vocab, size=(plen,)).astype(np.int32), max_new=4))
    t0 = time.perf_counter()
    done = meng.run()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in done)
    searches = len(meng.search_stats)
    print(f"MCTS slot engine: {len(done)} requests, {tok} searched tokens "
          f"in {searches} lockstep ticks, {tok/dt:.1f} tok/s "
          f"(3 slots, 3 trees searched as one forest)")
    out["mcts_slot"] = done

    # ---- part 4: TPFIFO work-sharing queue ----------------------------
    # the paper's thread pool as a serving scheduler: grain-sized quanta,
    # chunked prefill (the 28-token prompt never blocks the short ones),
    # preemption and requeue after 4 quanta, p50/p95 queue telemetry
    qeng = TPFIFOEngine(params, cfg, n_slots=4, max_len=64, grain=8,
                        policy="fifo", preempt_quanta=4, device=dev)
    qeng.submit(Request(rid=0, prompt=draw.integers(
        1, cfg.vocab, size=(28,)).astype(np.int32), max_new=8))
    for rid in range(1, 8):
        plen = int(draw.integers(4, 10))
        qeng.submit(Request(rid=rid, prompt=draw.integers(
            1, cfg.vocab, size=(plen,)).astype(np.int32), max_new=12))
    t0 = time.perf_counter()
    done = qeng.run()
    dt = time.perf_counter() - t0
    st = qeng.stats()
    tok = sum(len(r.out) for r in done)
    print(f"TPFIFO engine: {len(done)} requests, {tok} tokens in "
          f"{qeng._ticks} quanta of m=8, {tok/dt:.1f} tok/s; queue wait "
          f"p50/p95 {st.queue_wait_p50*1e3:.0f}/{st.queue_wait_p95*1e3:.0f} "
          f"ms, latency p95 {st.latency_p95*1e3:.0f} ms, "
          f"{st.n_preemptions} preemptions")
    out["tpfifo"] = done
    return out


if __name__ == "__main__":
    main()
