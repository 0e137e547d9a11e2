"""The models sharded with DTensor (``sharding.rules.shard`` at the
reference's annotations, the regions of ``local_region``) equal the
unsharded port.

Each family's reduced twin (dense, MoE, hybrid, xLSTM, vlm, encdec, and a
dense twin whose 3 kv heads do not divide the model axis) runs on a (2, 2)
("data", "model") gloo mesh of 4 processes spawned on one ``FileStore``
(``tests/torch_sharded_util.py``): the prefill's logits and cache, one
decode step's logits and cache, the gradients and one AdamW step's loss and
updated parameters, each against the same computation unsharded, in
float32, each step under its kind's rules (``launch.inputs.
rules_for_shape``: the decode cache split over its length). The same
processes run the regions no family's train step reaches — ``sdpa`` over a
split cache, forward and backward, and the cache write at an int
position. The unsharded port is held to the JAX package elsewhere
(``test_torch_families.py``, ``test_torch_train_*.py``).

Tolerances: 1e-5 of each tensor's (or tree leaf's) largest magnitude. Two
families' float32 results differ from their own float64 by more than that
— the hybrid's chunked scan by 5e-6 in its logits and 1.5e-5 in its
gradients, the 16-layer xLSTM's exponential gates by 2.7e-5 and 5.4e-5
(measured on these twins) — and a sharded run's sums are ordered
differently again: zamba2 is held to 1e-4, xLSTM to 1e-4 in its logits
and caches and 1e-3 in its gradients and updated parameters (the bounds
``test_torch_train_grads.py`` holds them to against JAX).

Also: ``shard`` outside a mesh is its argument itself with no op
dispatched (every single-card path keeps its bits and launches), and the
refusals inside an LM mesh (a plain tensor, flash attention, a split norm
axis)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.sharding import rules as shr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_sharded_util.py")
FAMILIES = {"dense": "llama3-8b", "moe": "qwen3-moe-235b-a22b",
            "hybrid": "zamba2-7b", "xlstm": "xlstm-1.3b",
            "vlm": "paligemma-3b", "encdec": "seamless-m4t-medium",
            "dense_kv3": "llama3-8b/kv3"}
CHECKS = ("prefill_logits", "prefill_cache", "decode_logits",
          "decode_cache", "train_grads", "train_loss", "train_params")
TOL = 1e-5
TOL_FAMILY = {"hybrid": dict.fromkeys(CHECKS, 1e-4),
              "xlstm": {**dict.fromkeys(CHECKS, 1e-4),
                        "train_grads": 1e-3, "train_params": 1e-3}}


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Rank 0's comparison of every family, from 4 gloo processes (the
    group lives and dies in them: this process starts none)."""
    d = tmp_path_factory.mktemp("gloo")
    store, out = d / "store", d / "out.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "4", str(store), str(out),
         *FAMILIES.values(), "regions"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_family_equals_unsharded(gloo_results, family, check):
    got = gloo_results[FAMILIES[family]][check]
    tol = TOL_FAMILY.get(family, {}).get(check, TOL)
    assert got <= tol, (family, check, got, tol)


REGION_CHECKS = ("split_kv_out_4", "split_kv_grads_4", "split_kv_out_1",
                 "split_kv_grads_1", "cache_write_int")


@pytest.mark.parametrize("check", REGION_CHECKS)
def test_sharded_region_equals_its_unsharded_body(gloo_results, check):
    """``sdpa`` over a split cache, forward and backward (the all-reduced
    softmax denominator's gradient is summed over the split), and the cache
    write at an int position (tests/torch_sharded_util.py:run_regions)."""
    got = gloo_results["regions"][check]
    assert got <= TOL, (check, got)


# ------------------------------------------------- single-card paths ----
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("axes", [("batch", "act_seq", None),
                                  ("batch", None, "heads", None),
                                  ("expert_group", "expert", None, None)])
def test_shard_outside_a_mesh_is_the_identity_with_no_op(axes):
    x = torch.randn(*(4,) * len(axes))
    with _Ops() as seen:
        assert shr.shard(x, axes) is x
        with shr.use_rules(shr.DEFAULT_RULES, None):
            assert shr.shard(x, axes) is x
        ens = lmesh.make_ensemble_mesh(["cpu"] * 2)
        with shr.use_rules(shr.DEFAULT_RULES, ens):
            assert shr.shard(x, axes) is x
    assert seen.ops == []


# ------------------------------------------------------ inside a mesh ----
@pytest.fixture
def mesh42():
    """A (4, 2) ("data", "model") CPU mesh on a fake process group of 8
    ranks, this process rank 0; torn down after the test."""
    from torch.distributed.device_mesh import DeviceMesh
    with lmesh.fake_process_group(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                          mesh_dim_names=("data", "model"))
        with shr.use_rules(shr.DEFAULT_RULES, mesh):
            yield mesh


def test_shard_redistributes_a_dtensor_to_its_annotation(mesh42):
    from torch.distributed.tensor import Replicate, Shard
    x = shr.distribute_to(mesh42, torch.empty(8, 6, 16, device="meta"),
                          ("batch", None, None))
    assert tuple(x.placements) == (Shard(0), Replicate())
    assert shr.shard(x, ("batch", None, None)) is x
    y = shr.shard(x, ("batch", None, "mlp"))
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert tuple(y.to_local().shape) == (2, 6, 8)
    # 6 does not divide over model = 2 x ... : kept whole where it does not
    z = shr.shard(x, ("batch", "act_seq", None))
    assert tuple(z.placements) == (Shard(0), Shard(1))
    odd = shr.distribute_to(mesh42, torch.empty(8, 3, device="meta"),
                            ("batch", None))
    assert tuple(shr.shard(odd, ("batch", "heads")).placements) == (
        Shard(0), Replicate())


def test_shard_refuses_a_plain_tensor_inside_an_lm_mesh(mesh42):
    with pytest.raises(TypeError, match="plain Tensor"):
        shr.shard(torch.zeros(8, 16), ("batch", "embed"))


def test_placements_split_a_dimension_major_to_minor(mesh42):
    from torch.distributed.tensor import Replicate, Shard
    assert shr.placements_for(mesh42, shr.P(("data", "model"), None)) == (
        Shard(0), Shard(0))
    assert shr.placements_for(mesh42, shr.P(None, "model")) == (
        Replicate(), Shard(1))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shr.placements_for(mesh42, shr.P(("model", "data")))


def test_flash_and_a_split_norm_axis_refuse_inside_an_lm_mesh(mesh42):
    q = shr.distribute_to(mesh42, torch.empty(4, 8, 2, 16, device="meta"),
                          ("batch", None, "heads", None))
    with pytest.raises(ValueError, match="use_flash off"):
        ops.flash_attention(q, q, q)
    x = shr.distribute_to(mesh42, torch.empty(4, 8, 16, device="meta"),
                          ("batch", None, "mlp"))
    w = shr.distribute_to(mesh42, torch.empty(16, device="meta"), (None,))
    with pytest.raises(ValueError, match="normed axis"):
        ops.rmsnorm(x, w)
