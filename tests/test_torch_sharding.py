"""The logical-axis sharding rules and the meshes: the port ==
``repro.sharding.rules`` and ``repro.launch.mesh``.

``logical_to_spec`` and ``_divisible_spec`` read only a mesh's
``axis_names`` and ``devices.shape``, so the reference's functions run on a
duck-typed mesh here and need no JAX devices; the port's run on its own
``launch.mesh.Mesh`` of CPU entries. They agree on every rule, on every
ordered pair and a sample of triples of logical axes, over the (4, 2)
single-pod and (2, 16, 16) multi-pod meshes, the 1-D ensemble mesh and no
mesh.
"""

from __future__ import annotations

import itertools
import types

import numpy as np
import pytest
import torch

from repro.sharding import rules as jrules
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import rules as trules

MESHES = {
    "single_pod": ((4, 2), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
    "ensemble": ((3,), ("ens",)),
}
AXES = list(trules.DEFAULT_RULES) + [None, "not_a_rule"]


def meshes(name):
    """(the port's Mesh, a duck-typed mesh for the reference), or Nones."""
    if name is None:
        return None, None
    shape, names = MESHES[name]
    port = tmesh.make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))
    ref = types.SimpleNamespace(axis_names=names,
                                devices=np.empty(shape, dtype=object))
    return port, ref


def as_tuple(spec):
    return tuple(spec)


def test_default_rules_equal_reference():
    assert trules.DEFAULT_RULES == jrules.DEFAULT_RULES
    assert trules.DEFAULT_RULES["ensemble"] == "ens"


@pytest.mark.parametrize("name", [*MESHES, None])
def test_logical_to_spec_equals_reference(name):
    port, ref = meshes(name)
    combos = ([(a,) for a in AXES]
              + list(itertools.permutations(AXES, 2))
              + list(itertools.permutations(AXES[::3], 3)))
    for axes in combos:
        got = trules.logical_to_spec(axes, trules.DEFAULT_RULES, port)
        want = jrules.logical_to_spec(axes, jrules.DEFAULT_RULES, ref)
        assert isinstance(got, trules.P)
        assert as_tuple(got) == as_tuple(want), axes
        named = [e for x in got if x is not None
                 for e in (x if isinstance(x, tuple) else (x,))]
        assert len(named) == len(set(named)), axes   # no mesh axis twice


@pytest.mark.parametrize("name", list(MESHES))
def test_divisible_spec_equals_reference(name):
    port, ref = meshes(name)
    dims = (1, 2, 3, 4, 6, 8, 16, 32, 48, 64, 512)
    for axes in list(itertools.permutations(AXES, 2)):
        spec_t = trules.logical_to_spec(axes, None, port)
        spec_j = jrules.logical_to_spec(axes, None, ref)
        for shape in itertools.product(dims[::2], dims[1::2]):
            got = trules._divisible_spec(spec_t, shape, port)
            want = jrules._divisible_spec(spec_j, shape, ref)
            assert as_tuple(got) == as_tuple(want), (axes, shape)
        # a spec shorter than the shape pads with None
        got = trules._divisible_spec(spec_t, (8, 16, 5), port)
        want = jrules._divisible_spec(spec_j, (8, 16, 5), ref)
        assert as_tuple(got) == as_tuple(want)


def test_use_rules_nests_and_restores():
    port, _ = meshes("single_pod")
    ens, _ = meshes("ensemble")
    custom = {"batch": "model"}
    assert trules.current_rules() is trules.DEFAULT_RULES
    assert trules.current_mesh() is None
    with trules.use_rules(custom, port):
        assert trules.current_rules() is custom
        assert trules.current_mesh() is port
        assert tuple(trules.logical_to_spec(("batch",))) == ("model",)
        with trules.use_rules(trules.DEFAULT_RULES, ens):
            assert trules.current_mesh() is ens
            assert tuple(trules.logical_to_spec(("batch", "ensemble"))) == (
                None, "ens")
        assert trules.current_rules() is custom
        assert trules.current_mesh() is port
    assert trules.current_rules() is trules.DEFAULT_RULES
    assert trules.current_mesh() is None


def test_named_shardings_carry_the_specs():
    port, _ = meshes("multi_pod")
    ns = trules.named_sharding(port, ("batch", "embed"))
    assert ns.mesh is port and as_tuple(ns.spec) == (("pod", "data"), None)
    nsf = trules.named_sharding_for(port, ("batch", "vocab"), (2, 40))
    assert as_tuple(nsf.spec) == ("pod", None)
    tree = {"w": ("embed", "mlp"), "layers": [("layers", "heads", None)],
            "scalar": 3}
    out = trules.tree_shardings(port, tree)
    assert as_tuple(out["w"].spec) == ("data", "model")
    assert as_tuple(out["layers"][0].spec) == (None, "model", None)
    assert out["scalar"] == 3


def test_shard_is_a_no_op_outside_a_mesh():
    x = torch.zeros(8, 16)
    assert trules.shard(x, ("batch", "embed")) is x
    ens, _ = meshes("ensemble")
    with trules.use_rules(trules.DEFAULT_RULES, ens):
        assert trules.shard(x, ("batch", "embed")) is x


def test_shard_places_a_dtensor_by_its_spec_inside_an_lm_mesh():
    """Inside a ``DeviceMesh`` (a fake process group of 8 ranks) ``shard``
    redistributes to the divisible spec the reference would constrain to;
    a device-list ``Mesh`` with LM axes is not an LM mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard
    port, ref = meshes("single_pod")
    x = torch.zeros(8, 16)
    with trules.use_rules(trules.DEFAULT_RULES, port):
        with pytest.raises(TypeError, match="DeviceMesh"):
            trules.shard(x, ("batch", "embed"))
    with tmesh.fake_process_group(8):
        dm = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                        mesh_dim_names=("data", "model"))
        with trules.use_rules(trules.DEFAULT_RULES, dm):
            d = trules.distribute_to(dm, x, (None, None))
            y = trules.shard(d, ("batch", "embed"))
            want = jrules._divisible_spec(jrules.logical_to_spec(
                ("batch", "embed"), None, ref), (8, 16), ref)
            assert as_tuple(want) == ("data", None)
            assert tuple(y.placements) == (Shard(0), Replicate())
            assert torch.equal(y.full_tensor(), x)


# ------------------------------------------------------------------ meshes ----
@pytest.mark.parametrize("n", range(1, 17))
def test_make_host_mesh_factors_like_the_reference(n):
    mesh = tmesh.make_host_mesh(devices=["cpu"] * n)
    m = max(d for d in (1, 2, 4, 8) if n % d == 0)
    assert mesh.axis_names == ("data", "model")
    assert tmesh.mesh_dims(mesh) == {"data": n // m, "model": m}
    if n % 2 == 0:
        forced = tmesh.make_host_mesh(model_axis=2, devices=["cpu"] * n)
        assert tmesh.mesh_dims(forced) == {"data": n // 2, "model": 2}


def test_make_host_mesh_defaults_and_mesh_dims():
    mesh = tmesh.make_host_mesh()
    n = max(1, torch.cuda.device_count())
    assert mesh.size == n and sum(tmesh.mesh_dims(mesh).values()) >= 2
    ref = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                devices=np.empty((2, 16, 16), dtype=object))
    port, _ = meshes("multi_pod")
    assert tmesh.mesh_dims(port) == dict(zip(ref.axis_names,
                                             ref.devices.shape))
    assert port.size == 512


def test_ensemble_mesh_keeps_repeats_and_refuses_missing_cards():
    mesh = tmesh.make_ensemble_mesh(["cpu", "cpu", "cpu"])
    assert mesh.axis_names == ("ens",) and mesh.size == 3
    assert mesh.device_list() == [torch.device("cpu")] * 3
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.make_ensemble_mesh(["cpu", missing])
    with pytest.raises(RuntimeError, match="needs"):
        tmesh.make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)


def test_production_mesh_builds_the_references_meshes():
    """The (16, 16) and (2, 16, 16) meshes over the first 256 or 512 ranks
    of a 512-rank fake group, with the reference's axis names; refused
    (as the reference refuses) with too few ranks."""
    with pytest.raises(RuntimeError, match="needs 256 ranks, found 0"):
        tmesh.make_production_mesh()
    with tmesh.fake_process_group():
        for multi_pod, dims in ((False, {"data": 16, "model": 16}),
                                (True, {"pod": 2, "data": 16, "model": 16})):
            mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
            assert tmesh.mesh_dims(mesh) == dims
            assert mesh.mesh.flatten().tolist() == list(
                range(256 * (1 + multi_pod)))
