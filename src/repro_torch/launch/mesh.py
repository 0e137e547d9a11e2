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
are into ``("data", "model")``. ``make_production_mesh`` (the 256- and
512-card LM meshes) belongs to the sharded analysis, ROADMAP.md A14b, and
refuses.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

A14B = ("the sharded analysis (ROADMAP.md A14b: the production meshes, "
        "counted under DTensor on a fake process group)")


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


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) LM mesh: not ported (A14b)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    raise NotImplementedError(f"make_production_mesh {shape}: {A14B}")


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


def mesh_dims(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, (int(d) for d in mesh.devices.shape)))
