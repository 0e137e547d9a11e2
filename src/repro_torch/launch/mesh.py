"""Device meshes (as FUNCTIONS — importing this never touches a device).

Port of ``repro.launch.mesh``. A ``Mesh`` is an ordered grid of
``torch.device`` entries with one name per axis: all that the callers of
the JAX package's ``jax.sharding.Mesh`` read (``mesh.devices.shape``,
``mesh.axis_names``). One process drives every entry of a mesh (a single
controller, as in the reference); no process group is made.

A device may appear more than once: two entries of the same device are two
*virtual shards*, the port's counterpart of the JAX package's
``--xla_force_host_platform_device_count``. Each shard still owns its own
storage, so a run on virtual shards goes through the same splits and
exchanges as one over real cards — which is how the tests rehearse the
multi-card path on the CPU and ``chip_smoke.py`` on one card.

``make_ensemble_mesh`` is the root-parallel forest's 1-D ``"ens"`` mesh
(``core.root_parallel``). ``make_host_mesh`` factors whatever devices there
are into ``("data", "model")``; ``make_group_mesh`` factors the ranks of
the initialized process group the same way, as the ``DeviceMesh`` that
``train.loop.train(mesh=)`` trains on, and ``process_group`` starts that
group for a launch.

``make_production_mesh`` is the reference's pair of LM meshes, the
sharded analysis's (``launch.dryrun``): single pod (16, 16) over ("data",
"model"), 256 ranks; multi-pod (2, 16, 16) over ("pod", "data", "model"),
512 ranks. Those are ``torch.distributed`` ``DeviceMesh``es over the first
256 or 512 ranks of the initialized process group: one process is one rank,
and a sharded step runs that rank's share under DTensor
(``sharding.rules.shard``). ``fake_process_group`` starts the group the
dry-run counts on: the ``"fake"`` backend, whose collectives move nothing,
with this process as rank 0 of 512. ``mesh_dims`` and ``axis_names`` take
either kind of mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

# the reference's production meshes: name -> (shape, axis names)
PRODUCTION_MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}
FAKE_WORLD = 512


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An ordered grid of devices with named axes: ``devices`` is a numpy
    object array of ``torch.device`` shaped like the mesh."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list[torch.device]:
        """The entries in mesh order (row-major), repeats kept."""
        return list(self.devices.reshape(-1))


def resolve_device(device) -> torch.device:
    """``device`` as a mesh entry: a CUDA device gets its index (``"cuda"``
    is the current card) and must exist on this host; anything else is
    taken as it is."""
    d = torch.device(device)
    if d.type != "cuda":
        return d
    n = torch.cuda.device_count()
    index = d.index
    if index is None and n:
        index = torch.cuda.current_device()
    if index is None or not 0 <= index < n:
        raise RuntimeError(
            f"mesh entry {d}: this host has {n} CUDA device(s)")
    return torch.device("cuda", index)


def visible_devices() -> list[torch.device]:
    """Every CUDA device of this host, in index order (none on a host
    without a card)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
              devices) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (exactly ``prod(shape)`` of
    them), row-major."""
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         "in rank")
    devs = [resolve_device(d) for d in devices]
    need = math.prod(shape)
    if len(devs) != need:
        raise RuntimeError(f"mesh {shape} needs {need} devices, "
                           f"got {len(devs)}")
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(devices=grid.reshape(shape), axis_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model") ``DeviceMesh`` over the first 256 or 512 ranks of the
    initialized process group (the single-pod mesh also inside a 512-rank
    world). ``device_type`` is where the ranks' shards live: ``"cpu"``
    also for ``meta`` shards, ``"cuda"`` for shards on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = PRODUCTION_MESHES["multipod" if multi_pod else "single"]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, found {have}. For the dry-run "
            f"start a fake process group of {FAKE_WORLD} ranks first "
            "(launch.mesh.fake_process_group; launch.dryrun does this).")
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


@contextlib.contextmanager
def fake_process_group(world_size: int = FAKE_WORLD, rank: int = 0):
    """A ``"fake"`` process group of ``world_size`` ranks with this process
    as ``rank``, unless a group is already initialized (then that one is
    used, and left as it is). Its collectives return at once and write
    nothing: what a sharded step counts or times under it is one rank's own
    work. Torn down on exit only if this call started it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


@contextlib.contextmanager
def process_group(device_type: str = "cuda"):
    """The process group a training launch runs in: the initialized one
    (left as it is), else one started from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
    ``LOCAL_RANK`` picks the card), else a group of this process alone on
    an in-process store: ``nccl`` for ``"cuda"``, ``gloo`` for ``"cpu"``.
    Torn down on exit only if started here. ``"cuda"`` on a host without a
    card raises: it does not fall back to the CPU."""
    import os

    import torch.distributed as dist

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("process_group: no CUDA device visible; ask for "
                           "the CPU (gloo) explicitly")
    backend = {"cuda": "nccl", "cpu": "gloo"}[device_type]
    started = not dist.is_initialized()
    if started:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device_type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def make_group_mesh(device_type: str = "cuda"):
    """The ``("data", "model")`` ``DeviceMesh`` over every rank of the
    initialized process group, factored as ``make_host_mesh`` factors
    devices."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    m = max(d for d in (1, 2, 4, 8) if n % d == 0)
    return DeviceMesh(device_type, torch.arange(n).reshape(n // m, m),
                      mesh_dim_names=("data", "model"))


def make_ensemble_mesh(devices=None) -> Mesh:
    """1-D mesh over the given (default: every visible CUDA device) devices
    on axis ``"ens"`` — the root-parallel forest's ensemble axis.

    Members are embarrassingly parallel, so the only mesh that matters is a
    flat ensemble axis (``core/root_parallel.py`` shards E trees over it).
    Repeat a device to rehearse on one card or on the CPU
    (``["cpu"] * 4``: four virtual shards).
    """
    devs = visible_devices() if devices is None else list(devices)
    if not devs:
        raise RuntimeError("make_ensemble_mesh: no device given and no CUDA "
                           "device visible")
    return make_mesh((len(devs),), ("ens",), devs)


def make_host_mesh(model_axis: int | None = None, devices=None) -> Mesh:
    """Best-effort mesh over whatever devices exist (tests, examples).

    Factors the device count into (data, model); ``model_axis`` forces the
    model dimension. ``devices`` defaults to every visible CUDA device, or
    the CPU on a host without one.
    """
    devs = list(devices) if devices is not None else (
        visible_devices() or [torch.device("cpu")])
    n = len(devs)
    m = model_axis or max(d for d in (1, 2, 4, 8) if n % d == 0)
    return make_mesh((n // m, m), ("data", "model"), devs)


def axis_names(mesh) -> tuple[str, ...]:
    """A ``Mesh``'s ``axis_names`` (or a duck-typed mesh's) or a
    ``DeviceMesh``'s dim names."""
    names = getattr(mesh, "axis_names", None)
    return tuple(mesh.mesh_dim_names if names is None else names)


def mesh_dims(mesh) -> dict[str, int]:
    """{axis name: size} of a ``Mesh`` or a ``DeviceMesh``."""
    shape = (mesh.devices.shape if hasattr(mesh, "devices")
             else tuple(mesh.mesh.shape))
    return dict(zip(axis_names(mesh), (int(d) for d in shape)))
