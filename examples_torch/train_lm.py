"""End-to-end LM training on the synthetic pipeline, on the port.

The torch twin of ``examples/train_lm.py``: a SmolLM-family model with the
whole single-card stack — the deterministic data pipeline, AdamW with the
cosine schedule, microbatch gradient accumulation (the grain-size dial),
async checkpointing with resume, the bad-step skip and the straggler
watchdog (``repro_torch.train.loop``).

The default is the JAX example's small twin (4 layers, d 256, vocab 2,048,
float32); ``--full`` trains the real smollm-135m config (float32, as the
JAX example's ``--full``). On the card every norm runs the rmsnorm kernel,
forward and (through its plain version's gradient) backward;
``--device cpu`` runs the kernels' plain PyTorch versions. Checkpoints go
to ``--ckpt-dir`` (default: under the system's temporary directory); run
again to resume.

    python examples_torch/train_lm.py [--steps 300] [--full] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402

# sizes (module constants, so a test can shrink them)
SMALL = dict(n_layers=4, d_model=256, d_ff=512, vocab=2048)
SMALL_DATA = dict(seq_len=128, global_batch=16)
FULL_DATA = dict(seq_len=512, global_batch=8)
WARMUP = 20
CKPT_EVERY = 100
LOG_EVERY = 20


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--full", action="store_true",
                   help="the real smollm-135m config")
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train_lm"))
    p.add_argument("--microbatches", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, default) or cpu (plain versions)")
    args = p.parse_args(argv)

    if args.full:
        cfg = configs.get_config("smollm-135m").replace(
            param_dtype="float32", compute_dtype="float32")
        data = DataConfig(**FULL_DATA)
    else:
        cfg = configs.reduced_config("smollm-135m").replace(**SMALL)
        data = DataConfig(**SMALL_DATA)

    out = train(
        cfg,
        OptConfig(lr=1e-3, warmup_steps=WARMUP, total_steps=args.steps),
        data,
        LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=CKPT_EVERY, log_every=LOG_EVERY,
                   n_microbatches=args.microbatches),
        device=args.device,
    )
    h = out["history"]
    print(f"\nloss {h[0]['loss']:.3f} -> {out['final_loss']:.3f} over "
          f"{len(h)} steps ({out['steps_per_s']:.2f} steps/s); "
          f"checkpoints in {args.ckpt_dir} (re-run to resume)")
    return out


if __name__ == "__main__":
    main()
