"""TPFIFO vs lockstep serving under a Poisson arrival trace, on the port.

The torch twin of ``benchmarks/tpfifo.py`` and the serving analogue of the
paper's Table I grain sweep: the same request trace is replayed against
the lockstep slot engine (one decode step per tick, whole-prompt prefill
per admission) and against the TPFIFO work-sharing queue at several grain
sizes (``m`` unified prefill/decode micro-steps per dispatch). On a
dispatch-bound host, coarser grains amortize the per-dispatch overhead
across ``m`` micro-steps of every slot — throughput rises with ``m`` until
the quantum tail (dead lanes riding to the quantum boundary) eats the
gain.

The same ``make_trace``, engines, sweep and result keys as the JAX twin,
plus ``device`` (the card's name and power limit, or ``"cpu"``); the
result goes to ``artifacts/bench_torch/tpfifo.json``. The JAX twin's
acceptance threshold (best TPFIFO >= 1.3x lockstep) was set for its CPU
host; it is reported here, not asserted.

    PYTHONPATH=src python -m benchmarks_torch.tpfifo [--smoke|--full] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch import configs
from repro_torch.models import api
from repro_torch.serve.engine import Request, SlotEngine
from repro_torch.serve.tpfifo import TPFIFOEngine

from benchmarks_torch.common import device_stamp, resolve_device, save_result

ACCEPT_SPEEDUP = 1.3


def make_trace(n_requests: int, rate_rps: float, max_new: int,
               short_lens, long_lens, vocab: int, seed: int):
    """Poisson arrivals, bimodal prompt lengths (the irregular workload):
    every third request draws from ``long_lens``."""
    rng = np.random.default_rng(seed)
    trace, t = [], 0.0
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        lens = long_lens if rid % 3 == 2 else short_lens
        plen = int(rng.integers(lens[0], lens[1] + 1))
        prompt = rng.integers(1, vocab, size=(plen,)).astype(np.int32)
        trace.append((t, dict(rid=rid, prompt=prompt, max_new=max_new)))
    return trace


def requests(trace):
    return [(t, Request(rid=r["rid"], prompt=r["prompt"].copy(),
                        max_new=r["max_new"])) for t, r in trace]


def serve_trace(engine, trace) -> dict:
    engine.run_trace(requests(trace))
    st = engine.stats()
    assert st.n_finished == len(trace), \
        f"only {st.n_finished}/{len(trace)} requests finished"
    out = st.as_dict()
    out["ticks"] = engine._ticks
    return out


def run(n_requests: int = 24, slots: int = 4, max_len: int = 96,
        max_new: int = 48, rate_rps: float = 200.0,
        grains=(1, 4, 8, 16, 32), policies=("fifo", "rebalance",
                                            "one_per_core"),
        short_lens=(4, 10), long_lens=(16, 40), seed: int = 0,
        smoke: bool = False, device=None) -> dict:
    # decode-heavy mixed-length trace, as in the JAX twin: TPFIFO replays
    # prompts token by token through the quantum (chunked prefill), so a
    # prefill-heavy trace would measure that replay, not the grain
    if smoke:
        n_requests, max_new, grains = 6, 24, (8,)
        short_lens, long_lens, max_len = (4, 8), (10, 16), 48
        policies = ("fifo",)
    device = resolve_device(device)

    cfg = configs.reduced_config("smollm-135m").replace(n_layers=2)
    params = api.init_params(cfg, seed=seed, device=device)
    trace = make_trace(n_requests, rate_rps, max_new, short_lens, long_lens,
                       cfg.vocab, seed)
    # warm-up: every distinct prompt length once (max_new=2 so warming
    # also reaches the decode step), so the first timed trace pays no
    # allocator or library set-up
    seen, warm = set(), []
    for t, r in trace:
        if len(r["prompt"]) not in seen:
            seen.add(len(r["prompt"]))
            warm.append((0.0, dict(r, max_new=2)))

    def lockstep():
        return SlotEngine(params, cfg, n_slots=slots, max_len=max_len,
                          eos_id=-1, seed=seed, device=device)

    def tpfifo(grain, policy="fifo"):
        return TPFIFOEngine(params, cfg, n_slots=slots, max_len=max_len,
                            grain=grain, policy=policy, eos_id=-1, seed=seed,
                            device=device)

    serve_trace(lockstep(), warm)
    serve_trace(tpfifo(grains[0]), warm)

    lock = serve_trace(lockstep(), trace)
    sweep = {}
    for g in grains:
        r = serve_trace(tpfifo(g), trace)
        r["speedup_vs_lockstep"] = (r["throughput_tok_s"]
                                    / lock["throughput_tok_s"])
        sweep[str(g)] = r
    best_g = max(sweep, key=lambda g: sweep[g]["throughput_tok_s"])
    pol = {}
    for p in policies:
        if p == "fifo":
            continue       # already measured in the grain sweep
        r = serve_trace(tpfifo(int(best_g), policy=p), trace)
        r["speedup_vs_lockstep"] = (r["throughput_tok_s"]
                                    / lock["throughput_tok_s"])
        pol[p] = r
    best = sweep[best_g]["speedup_vs_lockstep"]
    return {
        "config": {"n_requests": n_requests, "slots": slots,
                   "max_len": max_len, "max_new": max_new,
                   "rate_rps": rate_rps, "short_lens": list(short_lens),
                   "long_lens": list(long_lens), "seed": seed,
                   "smoke": smoke},
        "device": device_stamp(device),
        "lockstep": lock,
        "tpfifo": sweep,
        "policies_at_best_grain": pol,
        "best_grain": int(best_g),
        "best_speedup": best,
        "acceptance": {"threshold": ACCEPT_SPEEDUP,
                       "pass": best >= ACCEPT_SPEEDUP},
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true",
                   help="tiny trace (a check that it runs)")
    p.add_argument("--full", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default: cuda")
    args = p.parse_args(argv)

    out = run(smoke=args.smoke, n_requests=48 if args.full else 24,
              device=args.device)
    lk = out["lockstep"]
    print(f"lockstep : {lk['throughput_tok_s']:8.1f} tok/s   "
          f"p50/p95 latency {lk['latency_p50']*1e3:6.0f}/"
          f"{lk['latency_p95']*1e3:6.0f} ms")
    for g, r in out["tpfifo"].items():
        print(f"tpfifo m={g:>2}: {r['throughput_tok_s']:8.1f} tok/s   "
              f"p50/p95 latency {r['latency_p50']*1e3:6.0f}/"
              f"{r['latency_p95']*1e3:6.0f} ms   "
              f"{r['speedup_vs_lockstep']:5.2f}x")
    for pname, r in out["policies_at_best_grain"].items():
        print(f"policy {pname:>12} @m={out['best_grain']}: "
              f"{r['throughput_tok_s']:8.1f} tok/s   "
              f"{r['speedup_vs_lockstep']:5.2f}x")
    print("->", save_result("tpfifo", out))
    acc = out["acceptance"]
    print(f"best tpfifo vs lockstep (the JAX twin's threshold "
          f"{acc['threshold']}x): {out['best_speedup']:.2f}x at grain "
          f"{out['best_grain']}")
    return out


if __name__ == "__main__":
    main()
