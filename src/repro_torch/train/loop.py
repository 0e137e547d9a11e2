"""Fault-tolerant training loop, on one card or on a mesh:
checkpoint/restart, skip-on-spike, watchdog (port of
``repro.train.loop``).

- **restart**: on startup the loop restores the newest valid checkpoint
  (params, optimizer and the data iterator's step) and continues exactly
  where the failed run left off; a crash loses at most ``ckpt_every``
  steps.
- **async checkpointing**: the device-to-host snapshot is synchronous, the
  disk I/O overlaps the next steps (``checkpoint.store.AsyncSaver``). The
  end of the run saves its last step unless a periodic save just did (the
  reference writes that step a second time, the same bytes).
- **bad-step skip**: a non-finite gradient norm leaves params and moments
  untouched (``optim.adamw``).
- **straggler watchdog**: per-step wall times feed a rolling median; a step
  slower than ``watchdog_factor`` x the median is logged.

Each step ends in a host read of its metrics, which waits for the card: a
step's wall time is its device time plus whatever the host adds. The
history and the return dict have the reference's fields.

With ``mesh=`` (a ``DeviceMesh`` over the process group's ranks, one
process a rank) every rank runs the loop: the state is placed by
``train.step.state_shardings`` (a fresh one made whole, then placed; a
resume restored onto the mesh), and each rank draws the same global batch
from the seed and keeps its block (``train.step.jit_train_step``). A
checkpoint is gathered on every rank and written by rank 0
(``checkpoint.store``).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import store
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_batch_fn
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import step as step_mod


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    n_microbatches: int = 1
    watchdog_factor: float = 3.0
    seed: int = 0


def train(cfg: ModelConfig, opt_cfg: adamw.OptConfig, data_cfg: DataConfig,
          loop: LoopConfig, mesh=None, log: Callable[[str], None] = print,
          device=None) -> dict[str, Any]:
    """Run (or resume) a training job on ``device`` (``None`` = CUDA), or
    on ``mesh``, whose device type it must be; returns the final metrics
    and the history. The newest checkpoint in ``loop.ckpt_dir`` is resumed
    from; without one, fresh weights from ``loop.seed``."""
    device = step_mod._device(device)
    shardings = None
    if mesh is not None:
        if mesh.device_type != device.type:
            raise ValueError(f"train: a {mesh.device_type} mesh, device "
                             f"{device}")
        shardings = step_mod.state_shardings(mesh, cfg)
    step_fn = step_mod.make_train_step(cfg, opt_cfg, loop.n_microbatches)
    batch_fn = make_batch_fn(data_cfg, cfg)

    start_step = 0
    state = None
    saver = None
    if loop.ckpt_dir:
        saver = store.AsyncSaver(loop.ckpt_dir, keep=loop.ckpt_keep)
        last = store.latest_step(loop.ckpt_dir)
        if last is not None:
            state, extra = store.restore(loop.ckpt_dir, last,
                                         step_mod.abstract_state(cfg),
                                         shardings, device=device)
            start_step = int(extra.get("data_step", last))
            log(f"[resume] restored step {last}, data_step {start_step}")

    if state is None:
        state = step_mod.make_state(cfg, loop.seed, device=device)
        if mesh is not None:
            state = step_mod.place_state(cfg, state, shardings)
    if mesh is not None:
        step_fn = step_mod.jit_train_step(step_fn, mesh, cfg,
                                          batch_fn(start_step))
    state = step_mod.trainable_state(cfg, state)

    data = Prefetcher(batch_fn, start_step=start_step)
    history: list[dict] = []
    times: list[float] = []
    stragglers = 0
    next_step = start_step
    saved = None
    try:
        for step, batch in data:
            if step >= loop.steps:
                break
            next_step = step + 1
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            m = {k: float(v) for k, v in metrics.items()}   # waits for it
            dt = time.perf_counter() - t0
            times.append(dt)
            if len(times) >= 8:
                med = statistics.median(times[-64:])
                if dt > loop.watchdog_factor * med:
                    stragglers += 1
                    log(f"[watchdog] step {step}: {dt:.3f}s "
                        f">{loop.watchdog_factor:.1f}x median {med:.3f}s "
                        f"(straggler suspected)")
            m["step"] = step
            m["time_s"] = dt
            history.append(m)
            if m["skipped"]:
                log(f"[skip] step {step}: non-finite grads, update skipped")
            if step % loop.log_every == 0:
                log(f"step {step:5d} loss {m['loss']:.4f} "
                    f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} {dt:.3f}s")
            if saver and (step + 1) % loop.ckpt_every == 0:
                saver.save(step + 1, state, extra={"data_step": next_step})
                saved = step + 1
        if saver:
            if saved != next_step:   # the reference writes this step again
                saver.save(next_step, state, extra={"data_step": next_step})
            saver.wait()
    finally:
        data.close()

    return {
        "final_loss": history[-1]["loss"] if history else float("nan"),
        "history": history,
        "stragglers": stragglers,
        "steps_per_s": (len(times) / sum(times)) if times else 0.0,
        "state": state,
    }
