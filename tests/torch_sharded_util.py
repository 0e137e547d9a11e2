"""One rank of a sharded run on a (2, 2) ("data", "model") gloo mesh of 4
CPU processes: each family's reduced twin (float32) runs its prefill, one
decode step and one train step twice on every rank — unsharded on plain
tensors, and sharded on DTensors placed by the cell's rules — and rank 0
writes, per family and check, the largest relative difference of the
sharded result (gathered whole) from the unsharded one.

Run as ``python tests/torch_sharded_util.py RANK WORLD STORE OUT ARCH...``
(``tests/test_torch_sharded_models.py`` starts the four ranks and reads
OUT); the name ``regions`` in place of an arch checks the regions no
family's train step reaches (``run_regions``). Gathering a whole tensor is
this check's own doing: the models never gather an activation or a weight
whole.
"""

from __future__ import annotations

import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from torch.distributed.tensor import DTensor  # noqa: E402
from torch.distributed.tensor.experimental import implicit_replication  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import inputs as inp  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding import rules as shr  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

B, P, MAX_LEN = 4, 16, 24
TRAIN_S = 16


# a dense twin whose 3 kv heads do not divide the 2-wide model axis while
# its 6 q heads do: the kv heads stay whole, and each rank's q heads find
# theirs from the rank's head offset
KV3 = "llama3-8b/kv3"


def family_config(name: str):
    """The reduced twin (float32, flash off) of an arch, or ``KV3``."""
    arch = name.split("/")[0]
    cfg = configs.reduced_config(arch).replace(use_flash=False)
    if cfg.family == "moe":
        cfg = cfg.replace(moe_group_size=8)
    if name == KV3:
        cfg = cfg.replace(n_heads=6, n_kv_heads=3, head_dim=32)
    return cfg


def batch_for(cfg, S: int, train: bool, gen: torch.Generator) -> dict:
    text = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    b = {"tokens": torch.randint(0, cfg.vocab, (B, text), generator=gen,
                                 dtype=torch.int32)}
    if cfg.family == "vlm":
        b["patches"] = torch.randn(B, cfg.n_patches, cfg.vision_width,
                                   generator=gen)
    if cfg.family == "encdec":
        b["frames"] = torch.randn(B, 8, cfg.vision_width, generator=gen)
    if train:
        b["labels"] = torch.randint(0, cfg.vocab, (B, text), generator=gen,
                                    dtype=torch.int32)
        b["mask"] = (torch.rand(B, text, generator=gen) > 0.2).float()
    return b


ZERO_FLOOR = 1e-5


def whole(t) -> torch.Tensor:
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().double()


def rel(got, want) -> float:
    """The largest difference over the largest magnitude of ``want``."""
    g, w = whole(got), whole(want)
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))


def tree_rel(got, want) -> float:
    """``rel`` of each leaf of a tree, each over the larger of its own
    largest magnitude and ZERO_FLOOR x the tree's (a leaf whose values are
    all near zero — a gate's bias with no gradient to speak of — is held
    to the tree's scale); the worst leaf."""
    got, want = leaves(got), leaves(want)
    w = {k: whole(v) for k, v in want.items()}
    top = max(float(v.abs().max()) for v in w.values())
    return max(float((whole(got[k]) - v).abs().max())
               / max(float(v.abs().max()), ZERO_FLOOR * top, 1e-30)
               for k, v in w.items())


def leaves(tree) -> dict:
    if isinstance(tree, TransformerLM):
        tree = tree.tree()
    return dict(tree_leaves(tree)) if isinstance(tree, dict) else tree


def run_family(arch: str, mesh) -> dict:
    cfg = family_config(arch)
    out: dict = {}
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, 0, device="cpu")
    axes = api.param_axes(cfg)

    def sharded(kind: str, fn):
        shape = ShapeSpec(kind, kind, P, B)
        rules = inp.rules_for_shape(shape)
        with shr.use_rules(rules, mesh), implicit_replication():
            return fn(rules)

    # ---- prefill -------------------------------------------------------
    batch = batch_for(cfg, P, False, gen)
    ref_logits, ref_cache = api.prefill(params, cfg, batch, MAX_LEN)

    def prefill(rules):
        dp = inp.place_tree(mesh, params.tree(), axes, rules)
        db = inp.place_tree(mesh, batch, None, rules)
        return api.prefill(dp, cfg, db, MAX_LEN)

    logits, cache = sharded("prefill", prefill)
    out["prefill_logits"] = rel(logits, ref_logits)
    out["prefill_cache"] = tree_rel(cache, ref_cache)

    # ---- one decode step over the prefill's cache ----------------------
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                        dtype=torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32)    # the vlm's patches count
    cache0 = tree_map(lambda t: t.clone(), ref_cache)

    def decode(rules):
        dp = inp.place_tree(mesh, params.tree(), axes, rules)
        c_axes = tree_map(lambda t: t[2],
                          api.cache_specs(cfg, B, MAX_LEN,
                                          8 if cfg.family == "encdec"
                                          else None))
        dc = inp.place_tree(mesh, cache0, c_axes, rules)
        dt_, dpos = (inp.place_tree(mesh, {"t": tok, "p": pos},
                                    {"t": ("batch", None), "p": ("batch",)},
                                    rules)[k] for k in "tp")
        return api.decode(dp, cfg, dt_, dpos, dc)

    d_logits, d_cache = sharded("decode", decode)
    r_logits, r_cache = api.decode(params, cfg, tok, pos, ref_cache)
    out["decode_logits"] = rel(d_logits, r_logits)
    out["decode_cache"] = tree_rel(d_cache, r_cache)

    # ---- the gradients, and one train step -----------------------------
    # Adam's first step moves each parameter by lr * g / (|g| + eps): with
    # eps 1e-8 a gradient element near 1e-8, whose float32 sum over the
    # data shards differs from the unsharded one in its last bits, moves
    # its parameter by a visibly different amount. eps 1e-3 keeps the step
    # a smooth function of the gradients, which are compared themselves.
    tbatch = batch_for(cfg, TRAIN_S, True, gen)
    opt = adamw.OptConfig(warmup_steps=1, eps=1e-3)
    state = tstep.make_state(cfg, 0, device="cpu")
    s_axes = tstep.state_axes(cfg)

    def grads(rules):
        p = inp.place_tree(mesh, state["params"].tree(), s_axes["params"],
                           rules)
        p = TransformerLM(cfg, p, requires_grad=True)
        return tstep._value_and_grad(cfg, p, inp.place_tree(mesh, tbatch,
                                                            None, rules))

    _, d_grads = sharded("train", grads)
    _, r_grads = tstep._value_and_grad(cfg, state["params"], tbatch)
    out["train_grads"] = tree_rel(d_grads, r_grads)

    def train(rules):
        # the state placed by the divisibility-aware rules (the dense twin
        # with 3 kv heads on a 2-wide model axis); jit_train_step leaves
        # placed leaves alone and places the batch
        st = {"params": inp.place_tree(mesh, state["params"].tree(),
                                       s_axes["params"], rules),
              "opt": inp.place_tree(mesh, state["opt"], s_axes["opt"],
                                    rules)}
        return tstep.jit_train_step(tstep.make_train_step(cfg, opt), mesh,
                                    cfg, tbatch, rules)(st, tbatch)

    d_state, d_metrics = sharded("train", train)
    r_state, r_metrics = tstep.make_train_step(cfg, opt)(state, tbatch)
    out["train_loss"] = rel(d_metrics["loss"], r_metrics["loss"])
    out["train_params"] = tree_rel(d_state["params"], r_state["params"])
    return out


REGIONS = "regions"


def run_regions(mesh) -> dict:
    """The regions no family's train step reaches, against their unsharded
    bodies: ``sdpa`` over a cache whose length is split — its output and
    its gradients, with the cache split over "model" (4 rows) and over
    both axes (1 row, the rules of a one-row decode) — and the cache write
    at a Python int position."""
    from repro_torch.models import attention

    out: dict = {}
    gen = torch.Generator().manual_seed(1)
    for rows in (4, 1):
        Sq, H, Hkv, hd, S = 3, 4, 2, 8, 16
        q, g = (torch.randn(rows, Sq, H, hd, generator=gen) for _ in "qg")
        k, v = (torch.randn(rows, S, Hkv, hd, generator=gen) for _ in "kv")
        mask = torch.rand(rows, Sq, S, generator=gen) > 0.3
        mask[..., 0] = True
        ref = attention.sdpa(*(t.requires_grad_() for t in (q, k, v)), mask)
        r_grads = torch.autograd.grad(ref, (q, k, v), g)
        q_ax, kv_ax = ("batch", None, None, None), ("batch", "kv_len", None,
                                                     None)

        def run(rules):
            d = inp.place_tree(mesh, {"q": q.detach(), "k": k.detach(),
                                      "v": v.detach(), "g": g, "m": mask},
                               {"q": q_ax, "k": kv_ax, "v": kv_ax, "g": q_ax,
                                "m": ("batch", None, "kv_len")}, rules)
            dq, dk, dv = (d[n].requires_grad_() for n in "qkv")
            o = attention.sdpa(dq, dk, dv, d["m"])
            assert dk.to_local().shape[1] < S    # the cache really is split
            return o, torch.autograd.grad(o, (dq, dk, dv), d["g"])

        shape = ShapeSpec("decode", "decode", S, rows)
        with shr.use_rules(inp.rules_for_shape(shape), mesh), \
                implicit_replication():
            o, grads = run(inp.rules_for_shape(shape))
        out[f"split_kv_out_{rows}"] = rel(o, ref)
        out[f"split_kv_grads_{rows}"] = max(
            rel(a, b) for a, b in zip(grads, r_grads))

    cache = torch.randn(B, MAX_LEN, 2, 8, generator=gen)
    new = torch.randn(B, 1, 2, 8, generator=gen)
    want = attention.update_cache_at(cache.clone(), new, MAX_LEN - 3)
    rules = inp.rules_for_shape(ShapeSpec("decode", "decode", MAX_LEN, B))
    with shr.use_rules(rules, mesh), implicit_replication():
        dc = inp.place_tree(mesh, {"c": cache, "n": new},
                            {"c": ("batch", "kv_len", None, None),
                             "n": ("batch", None, None, None)}, rules)
        got = attention.update_cache_at(dc["c"], dc["n"], MAX_LEN - 3)
    out["cache_write_int"] = rel(got, want)
    return out


def main(argv) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    rank, world, store, out_path, *archs = argv
    rank, world = int(rank), int(world)
    torch.manual_seed(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                          mesh_dim_names=("data", "model"))
        results = {a: run_regions(mesh) if a == REGIONS
                   else run_family(a, mesh) for a in archs}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
