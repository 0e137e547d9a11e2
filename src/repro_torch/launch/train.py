"""Training launcher (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch smollm-135m``.

Host mode: trains the reduced config (``--full-config``: the published one)
on one card with the fault-tolerant loop (``repro_torch.train.loop``):
async checkpoints every ``--ckpt-every`` steps, resume from the newest
valid checkpoint, the non-finite-gradient skip, the straggler watchdog.

``--mesh`` trains on a ``("data", "model")`` mesh over the ranks of a
process group (``launch.mesh.process_group``: the one ``torchrun`` starts,
``torchrun --nproc-per-node N -m repro_torch.launch.train --mesh``, else a
group of this process alone), one rank a process, the state and the batch
sharded over the ranks; rank 0 prints.

The flags and the printed lines are the JAX launcher's, plus ``--device``
(default ``cuda``); ``--device cpu`` trains with the kernels' plain PyTorch
versions (and ``--mesh`` on gloo). ``--mesh --device cuda`` on a host
without a card raises.
"""

from __future__ import annotations

import argparse
import contextlib

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import LoopConfig, train


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-135m", choices=list(configs.ARCHS))
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--full-config", action="store_true",
                   help="use the full published config (default: reduced twin)")
    p.add_argument("--mesh", action="store_true",
                   help="train under a mesh over the ranks of the process "
                        "group (torchrun's, else this process alone)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, default) or cpu (plain versions)")
    args = p.parse_args(argv)

    cfg = (configs.get_config(args.arch) if args.full_config
           else configs.reduced_config(args.arch))
    with (lmesh.process_group(args.device) if args.mesh
          else contextlib.nullcontext()):
        return _run(args, cfg)


def _run(args, cfg):
    import torch.distributed as dist

    mesh = lmesh.make_group_mesh(args.device) if args.mesh else None
    lead = mesh is None or dist.get_rank() == 0
    out = train(
        cfg,
        OptConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                  total_steps=args.steps),
        DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                   seed=args.seed),
        LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every,
                   n_microbatches=args.microbatches, seed=args.seed),
        mesh=mesh, log=print if lead else (lambda line: None),
        device=args.device,
    )
    if lead:
        print(f"final loss {out['final_loss']:.4f} | "
              f"{out['steps_per_s']:.2f} steps/s | "
              f"stragglers {out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
