"""The port's collective accounting (``repro_torch.roofline.collectives``)
against the reference's ``repro.roofline.collectives``: the ring model's
operand and wire bytes for every op and group size, and the collectives a
sharded step issues recorded from the dispatched ops (``OpCosts`` under a
fake process group: DTensor's redistributions and the regions' own
all-reduces, each with its result's bytes and its group's size)."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from repro.roofline import collectives as jcoll
from repro_torch.launch import mesh as lmesh
from repro_torch.roofline import collectives as tcoll
from repro_torch.roofline.op_costs import OpCosts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


@pytest.mark.parametrize("group", [1, 2, 16, 512])
@pytest.mark.parametrize("op", OPS)
def test_collective_bytes_equal_the_reference(op, group):
    for result in (0, 1, 4096, 3 * 5 * 7 * 512):
        t = tcoll.Collective(op, result, group)
        j = jcoll.Collective(op, result, group)
        assert t.operand_bytes == j.operand_bytes
        assert t.wire_bytes == j.wire_bytes


def test_summarize_equals_the_reference():
    calls = [(op, 1000 * (i + 1), g) for i, op in enumerate(OPS)
             for g in (2, 16)]
    t = tcoll.summarize([tcoll.Collective(*c) for c in calls])
    j = jcoll.summarize([jcoll.Collective(*c) for c in calls])
    assert t == j


def test_the_module_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = ("import sys; import repro_torch.roofline.collectives, "
            "repro_torch.roofline.op_costs, repro_torch.launch.dryrun; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules), sorted(m for m in sys.modules "
            "if 'jax' in m or m.startswith('repro.'))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.fixture
def mesh42():
    """A (4, 2) ("data", "model") CPU mesh on a fake process group of 8
    ranks, this process rank 0; the group is torn down after the test."""
    from torch.distributed.device_mesh import DeviceMesh
    with lmesh.fake_process_group(8):
        yield DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                         mesh_dim_names=("data", "model"))


def _dt(mesh, shape, placements):
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.shape[i]
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def test_redistributions_are_recorded_with_result_bytes_and_group(mesh42):
    """Each DTensor redistribution is one recorded collective: its result's
    bytes (the gathered tensor of an all-gather, the scattered one of a
    reduce-scatter) and its group's size (the mesh axis it runs over). On a
    CPU mesh DTensor's shard-to-shard all-to-all runs as an all-gather and
    a chunk; it is recorded as the one all-to-all it stands for."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x = _dt(mesh42, (16, 32), (Shard(0), Replicate()))
    p = _dt(mesh42, (16, 32), (Replicate(), Partial()))
    y = _dt(mesh42, (16, 32), (Shard(0), Shard(1)))
    with OpCosts() as oc:
        x.redistribute(mesh42, (Replicate(), Replicate()))      # gather data
        p.redistribute(mesh42, (Replicate(), Replicate()))      # reduce model
        p.redistribute(mesh42, (Replicate(), Shard(0)))         # scatter
        x.redistribute(mesh42, (Shard(1), Replicate()))         # all-to-all
        y.redistribute(mesh42, (Shard(0), Replicate()))         # gather model
    got = [(c.op, c.result_bytes, c.group_size) for c in oc.collectives]
    f = 4   # float32
    assert got == [("all-gather", 16 * 32 * f, 4),
                   ("all-reduce", 16 * 32 * f, 2),
                   ("reduce-scatter", 8 * 32 * f, 2),
                   ("all-to-all", 16 * 8 * f, 4),
                   ("all-gather", 4 * 32 * f, 2)]
    costs = oc.rollup()
    summ = tcoll.summarize(oc.collectives)
    assert costs.coll_count == 5 and costs.coll_wire == summ["wire_bytes"]
    assert costs.coll_by_op == {op: [e["count"], e["wire_bytes"]]
                                for op, e in summ["by_op"].items()}
    # each collective charged 2 x its result's bytes (``hlo_costs``'), and
    # the gather along dim 1 its local reorder (chunk and cat) besides
    assert costs.bytes_major >= 2 * sum(c.result_bytes
                                        for c in oc.collectives)


def test_a_regions_all_reduce_and_its_groups(mesh42):
    """A region's own all-reduce (``sharding.rules.all_reduce``) is a
    recorded collective of the region's local result over the named axis;
    DTensor's sharding propagation (global shapes on fake tensors) is not
    charged: an op on DTensors costs its local shard's elements."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding import rules as shr
    x = _dt(mesh42, (16, 32), (Shard(0), Shard(1)))
    with shr.use_rules(shr.DEFAULT_RULES, mesh42), OpCosts() as oc:
        shr.local_region(lambda a: shr.all_reduce(a.sum(-1), "sum",
                                                  ("model",)),
                         [x], [(Shard(0), Shard(1))],
                         ((Shard(0), Replicate()), (16,)))
        (x * 2.0).exp()
    assert [(c.op, c.result_bytes, c.group_size) for c in oc.collectives] \
        == [("all-reduce", 4 * 4, 2)]
    # the local sum (4 x 16 -> 4), then 2 x and exp on the (4, 16) shard
    assert oc.flops == 4 + 2 * 4 * 16
