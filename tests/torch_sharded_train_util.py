"""Training on a mesh, both packages, for ``tests/test_torch_sharded_train.py``.

Two modes, each writing one JSON file (and the parameters it compares as an
``.npz`` beside it):

- ``python tests/torch_sharded_train_util.py rank RANK WORLD STORE OUT
  START``: one of 4 gloo processes on one ``FileStore``; rank 0 writes what
  the port computed:

  - ``compressed_psum`` over ``"pod"`` of a (2, 2) ("pod", "data") mesh
    against the exact all-reduce;
  - one ``make_train_step_compressed`` step on a (2, 2, 1) ("pod", "data",
    "model") mesh through ``jit_train_step``, from the step-0 state in
    START (the JAX package's, written by its store);
  - ``train.loop.train(mesh=)`` on the (2, 2) ("data", "model") mesh for
    STEPS steps from START, checkpointing every 2 steps, then a second run
    resumed from its step-2 checkpoint;
  - checkpoints between layouts: an unsharded save restored sharded, a
    sharded save restored unsharded, each leaf compared bit for bit.

- ``python tests/torch_sharded_train_util.py jax OUT START``: the
  reference on 4 host devices (``XLA_FLAGS`` set before JAX is imported):
  ``repro.train.loop.train(mesh=make_host_mesh(model_axis=2))`` from START,
  the compressed step on the (2, 2, 1) mesh, and ``state_shardings`` of the
  dense and MoE twins on (2, 2) and (1, 4) — on (1, 4) whether placing a
  state raises.

Gathering a whole tensor to compare it is this check's own doing.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

ARCH = "smollm-135m"
MOE = "qwen3-moe-235b-a22b"
N_LAYERS = 2
DATA = dict(seq_len=32, global_batch=8)
OPT = dict(warmup_steps=1, total_steps=3)
# the compressed step's parameters are compared after one AdamW step: with
# eps 1e-3 the step is a smooth function of the gradients (eps 1e-8 would
# magnify the last bits of a near-zero gradient; tests/torch_sharded_util.py)
COMPRESSED_EPS = 1e-3
STEPS = 3
CKPT_EVERY = 2
PSUM_SHAPE = (3, 1000)


# ------------------------------------------------------------------ port ----
def port_psum(mesh) -> dict:
    """``compressed_psum`` over "pod" against the exact sum: the error over
    the exact sum's largest magnitude, the largest excess over the
    elementwise bound n_pods x blockmax / 254 (blockmax: the block's largest
    magnitude over the pods), and whether every rank got the same sum."""
    import torch
    import torch.distributed as dist

    from repro_torch.optim import compression as comp

    gen = torch.Generator().manual_seed(100 + dist.get_rank())
    x = torch.randn(PSUM_SHAPE, generator=gen) * torch.logspace(
        -3, 2, PSUM_SHAPE[1])
    got = comp.compressed_psum(x, "pod", mesh=mesh)
    pod = mesh.get_group("pod")
    exact = x.clone()
    dist.all_reduce(exact, group=pod)
    blockmax = comp._pad_to(x.abs(), comp.BLOCK).reshape(-1, comp.BLOCK) \
        .amax(dim=1)
    dist.all_reduce(blockmax, op=dist.ReduceOp.MAX, group=pod)
    n_pods = dist.get_world_size(pod)
    bound = (n_pods * blockmax / 254.0).repeat_interleave(comp.BLOCK)[
        :x.numel()].reshape(x.shape)
    err = (got - exact).abs()
    same = [torch.empty_like(got) for _ in range(dist.get_world_size())]
    dist.all_gather(same, got)
    pod_of = [r // 2 for r in range(dist.get_world_size())]
    return {"err_over_scale": float(err.max() / exact.abs().max()),
            "excess_over_bound": float((err - bound).max()),
            "pod_peers_equal": all(
                torch.equal(same[r], same[q])
                for r in range(len(same)) for q in range(len(same))
                if r % 2 == q % 2 and pod_of[r] != pod_of[q])}


def port_compressed(mesh3, cfg, start: str) -> tuple[dict, dict]:
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import DataConfig, make_batch_fn
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as tstep

    state, _ = store.restore(start, 0, tstep.abstract_state(cfg),
                             device="cpu")
    batch = make_batch_fn(DataConfig(**DATA), cfg)(0)
    opt = OptConfig(**OPT, eps=COMPRESSED_EPS)
    step = tstep.jit_train_step(
        tstep.make_train_step_compressed(cfg, opt, mesh3), mesh3, cfg, batch)
    state, metrics = step(state, batch)
    params = {k: v.detach().full_tensor().numpy()
              for k, v in store._flatten(state["params"]).items()}
    return {k: float(v) for k, v in metrics.items()}, params


def port_train(mesh, cfg, start: str, work: str) -> dict:
    """The straight run from START, and a run resumed from its step-2
    checkpoint (rank 0 copies it into a fresh directory)."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import loop as tloop

    def run(ckpt: str, steps: int) -> tuple[dict, list]:
        log: list[str] = []
        out = tloop.train(cfg, OptConfig(**OPT), DataConfig(**DATA),
                          tloop.LoopConfig(steps=steps, ckpt_dir=ckpt,
                                           ckpt_every=CKPT_EVERY,
                                           log_every=1),
                          mesh=mesh, log=log.append, device="cpu")
        return out, log

    straight_dir = os.path.join(work, "straight")
    resume_dir = os.path.join(work, "resume")
    if dist.get_rank() == 0:
        shutil.copytree(start, straight_dir)
    dist.barrier()
    straight, log = run(straight_dir, STEPS)
    if dist.get_rank() == 0:
        os.makedirs(resume_dir)
        name = f"step_{CKPT_EVERY:09d}"
        shutil.copytree(os.path.join(straight_dir, name),
                        os.path.join(resume_dir, name))
    dist.barrier()
    resumed, rlog = run(resume_dir, STEPS)
    whole = lambda out: {k: v.detach().full_tensor() for k, v in store_flat(
        out["state"]["params"]).items()}
    a, b = whole(straight), whole(resumed)
    return {"losses": [h["loss"] for h in straight["history"]],
            "grad_norms": [h["grad_norm"] for h in straight["history"]],
            "log": log,
            "resumed_losses": [h["loss"] for h in resumed["history"]],
            "resumed_log": rlog,
            "resumed_params_equal": all(torch_equal(a[k], b[k]) for k in a),
            "state": straight["state"]}


def store_flat(tree) -> dict:
    from repro_torch.checkpoint import store
    return store._flatten(tree)


def torch_equal(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and torch.equal(a, b)


def port_checkpoints(mesh, cfg, sharded_state, work: str) -> dict:
    """An unsharded save (rank 0) restored onto the mesh, and a save of the
    sharded state restored unsharded: every leaf bit for bit."""
    import torch.distributed as dist

    from repro_torch.checkpoint import store
    from repro_torch.train import step as tstep

    plain = tstep.make_state(cfg, 3, device="cpu")
    plain["opt"]["step"].fill_(7)
    a_dir, b_dir = os.path.join(work, "plain"), os.path.join(work, "sharded")
    if dist.get_rank() == 0:
        store.save(a_dir, 1, plain, extra={"data_step": 1})
    dist.barrier()
    placed, extra = store.restore(a_dir, 1, tstep.abstract_state(cfg),
                                  tstep.state_shardings(mesh, cfg),
                                  device="cpu")
    got = store_flat(placed)
    want = store_flat(plain)
    to_sharded = (extra == {"data_step": 1} and all(
        type(v).__name__ == "DTensor" and torch_equal(v.full_tensor(),
                                                      want[k].detach())
        for k, v in got.items()))
    store.save(b_dir, 2, sharded_state)            # every rank; rank 0 writes
    back, _ = store.restore(b_dir, 2, tstep.abstract_state(cfg), device="cpu")
    want = {k: v.full_tensor() for k, v in store_flat(sharded_state).items()}
    to_plain = all(type(v).__name__ == "Tensor" and torch_equal(v, want[k])
                   for k, v in store_flat(back).items())
    return {"unsharded_to_sharded": to_sharded,
            "sharded_to_unsharded": to_plain,
            "leaves": len(want)}


def rank_main(rank: str, world: str, store_path: str, out: str,
              start: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import configs

    rank, world = int(rank), int(world)
    torch.manual_seed(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    work = os.path.join(os.path.dirname(out), "work")
    try:
        ranks = torch.arange(world)
        pod_mesh = DeviceMesh("cpu", ranks.reshape(2, 2),
                              mesh_dim_names=("pod", "data"))
        mesh3 = DeviceMesh("cpu", ranks.reshape(2, 2, 1),
                           mesh_dim_names=("pod", "data", "model"))
        mesh = DeviceMesh("cpu", ranks.reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        cfg = configs.reduced_config(ARCH).replace(n_layers=N_LAYERS)
        res = {"psum": port_psum(pod_mesh)}
        res["compressed"], params = port_compressed(mesh3, cfg, start)
        train = port_train(mesh, cfg, start, work)
        res["checkpoints"] = port_checkpoints(mesh, cfg, train.pop("state"),
                                              work)
        res["train"] = train
        if rank == 0:
            np.savez(out + ".npz", **params)
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- reference ----
def jax_main(out: str, start: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.checkpoint import store
    from repro.compat import make_auto_mesh
    from repro.data.pipeline import DataConfig, make_batch_fn
    from repro.launch.mesh import make_host_mesh
    from repro.optim.adamw import OptConfig
    from repro.train import loop, step
    from torch_train_util import spec_lists

    cfg = configs.reduced_config(ARCH).replace(n_layers=N_LAYERS)
    res: dict = {}
    ckpt = out + ".ckpt"
    shutil.copytree(start, ckpt)
    r = loop.train(cfg, OptConfig(**OPT), DataConfig(**DATA),
                   loop.LoopConfig(steps=STEPS, ckpt_dir=ckpt,
                                   ckpt_every=100, log_every=1),
                   mesh=make_host_mesh(model_axis=2), log=lambda s: None)
    res["train_losses"] = [h["loss"] for h in r["history"]]

    mesh3 = make_auto_mesh((2, 2, 1), ("pod", "data", "model"))
    batch = make_batch_fn(DataConfig(**DATA), cfg)(0)
    template = step.abstract_state(cfg)
    opt = OptConfig(**OPT, eps=COMPRESSED_EPS)
    fn = step.jit_train_step(step.make_train_step_compressed(cfg, opt, mesh3),
                             mesh3, cfg, batch)
    state, _ = store.restore(start, 0, template)
    state, metrics = fn(state, batch)
    res["compressed"] = {k: float(v) for k, v in metrics.items()}
    np.savez(out + ".npz", **{
        k: np.asarray(v.astype(jnp.float32))
        for k, v in store._flatten(state["params"]).items()})

    specs, refused = {}, {}
    for name in (ARCH, MOE):
        c = configs.reduced_config(name)
        mesh = make_auto_mesh((2, 2), ("data", "model"))
        specs[name] = spec_lists(step.state_shardings(mesh, c),
                                 jax.sharding.NamedSharding)
        narrow = make_auto_mesh((1, 4), ("data", "model"))
        try:
            jax.device_put(step.make_state(c, jax.random.key(0)),
                           step.state_shardings(narrow, c))
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)[:200]
    res["specs_2x2"], res["refused_1x4"] = specs, refused
    with open(out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    mode, *args = sys.argv[1:]
    (rank_main if mode == "rank" else jax_main)(*args)
