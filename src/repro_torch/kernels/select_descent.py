"""The whole lockstep descent of a selection round in one launch: the
hand-written CUDA kernel's wrapper.

Replaces, on the search's path, the TPU kernel ``repro/kernels/uct_select.py``
(``_uct_kernel``, wrapper ``uct_select``) together with the level loop
around it. The JAX reference runs that loop on the device
(``repro.core.gscpm.select_batch``, a ``lax.while_loop``); the port's plain
version (``core.gscpm.select_levels``) runs it eagerly, one
``child_stat_tile`` gather, one threefry noise draw and one ``uct_select``
launch per level, ~490 launches and a host read per level. The kernel is
``select_descent_kernel`` in ``csrc/uct_select.cu``: one warp walks one lane
from the root to its leaf, reading the tree's tensors in place, drawing
each slot's noise in registers (``csrc/threefry.cuh``) and scoring children
with the same ``uct_score`` as the one-tile kernel.

What bounds it on an H100: per level a chain of dependent gathers (node ->
child row -> child stats -> pick -> move), a few hundred nanoseconds each;
the bytes and operations are far below a microsecond. ``cp``,
``noise_scale``, ``max_depth``, W, C and n are run-time arguments.

A forest of E trees is ONE launch of E·W lanes: lane w walks member w / W,
every tree read offset by that member's (cap + 1) rows; paths and leaves
come back member-local, as ``jax.vmap(select_batch)`` returns them. A
single tree is E = 1.

The kernel writes a board as the games' shared convention has it (a move
is a cell; ``place`` sets that cell to the mover: Hex and Gomoku), for
boards of up to 625 cells (``MAX_CELLS``). ``select_descent_plain`` (``kernels.ref.
select_descent``) is the plain PyTorch version; ``kernels.ops.
select_descent`` chooses between the two by where the tensors lie.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import select_descent as select_descent_plain  # noqa: F401

MAX_CELLS = 625  # csrc/uct_select.cu: kMaxCells, the lane's board in shared memory
_launch = _build.Launcher("repro_select_descent")

# the tree's fields the kernel reads, with their dtype and whether they are
# (cap + 1,) rows (children is (cap + 1, C))
_TREE_FIELDS = (("children", torch.int32), ("n_children", torch.int32),
                ("wins", torch.float32), ("visits", torch.float32),
                ("vloss", torch.float32), ("move", torch.int32),
                ("to_move", torch.int32))


def _fits(t, shape, dtype, device: int) -> bool:
    return (isinstance(t, torch.Tensor) and t.dtype == dtype
            and t.shape == shape and t.get_device() == device
            and t.is_contiguous())


def _check(name: str, t, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"select_descent: {name} must be a tensor")
    if t.device != device:
        raise ValueError(
            f"select_descent: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(
            f"select_descent: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"select_descent: {name} has shape {tuple(t.shape)}, expected "
            f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"select_descent: {name} must be contiguous")


def _refuse(tree, root_board, noise_keys, max_depth) -> None:
    """Raise the error for arguments the kernel does not take: the first
    wrong shape, dtype, device or layout, else the CPU."""
    if not isinstance(root_board, torch.Tensor):
        raise TypeError("select_descent: root_board must be a tensor")
    dev = root_board.device
    if not 1 <= root_board.dim() <= 2:
        raise ValueError("select_descent: root_board must be (n,) or (E, n)")
    lead = tuple(root_board.shape[:-1])
    n = root_board.shape[-1]
    _check("root_board", root_board, (*lead, n), torch.int8, dev)
    if not 1 <= n <= MAX_CELLS:
        raise ValueError(f"select_descent: board of {n} cells outside "
                         f"1..{MAX_CELLS}")
    if tree.children.dim() != len(lead) + 2:
        raise ValueError("select_descent: children must be (cap + 1, C), or "
                         "(E, cap + 1, C) with (E, n) root boards")
    rows = tree.children.shape[-2]
    if rows < 2:
        raise ValueError("select_descent: children must be (cap + 1, C) with "
                         "cap >= 1")
    for name, dtype in _TREE_FIELDS:
        t = getattr(tree, name)
        shape = ((*lead, rows, tree.children.shape[-1]) if name == "children"
                 else (*lead, rows))
        _check(f"tree.{name}", t, shape, dtype, dev)
    W = noise_keys.shape[-2] if noise_keys.dim() >= 2 else 0
    _check("noise_keys", noise_keys, (*lead, W, 2), torch.int64, dev)
    if W < 1:
        raise ValueError("select_descent: no lanes")
    if max_depth < 1:
        raise ValueError(f"select_descent: max_depth {max_depth} < 1")
    raise ValueError(
        "select_descent: the kernel takes CUDA tensors; for CPU tensors "
        "call kernels.ops.select_descent (plain version)")


def select_descent(tree, root_board: torch.Tensor, noise_keys: torch.Tensor,
                   cp, noise_scale: float, max_depth: int):
    """One selection round of ``W = noise_keys.shape[-2]`` lanes on
    ``tree`` (a ``core.tree.Tree``, read in place, PAD row at ``cap``), or
    on each member of a forest.

    Single tree: root_board (n,) int8, noise_keys (W, 2). Forest of E
    members: tree fields (E, cap + 1[, C]), root_board (E, n), noise_keys
    (E, W, 2); ONE launch walks all E·W lanes, lane w of member e from its
    own root. Keys are int64 uint32 words; ``noise_scale`` 0 draws no
    noise. Returns ``(paths, depths, leaves, boards, n_empty)`` as
    ``core.gscpm.select_batch`` does, with the member axis first on a
    forest and member-local ids: (..., W, max_depth) int32 paths PAD-filled
    with ``paths[..., 0] == 0``, (..., W) int32 depths, leaves and empty
    counts, (..., W, n) int8 leaf boards. Launches on the current stream;
    every tensor must lie on the current CUDA device and be contiguous.
    """
    ok = (isinstance(root_board, torch.Tensor) and root_board.is_cuda
          and 1 <= root_board.dim() <= 2
          and tree.children.dim() == root_board.dim() + 1
          and noise_keys.dim() == root_board.dim() + 1 and max_depth >= 1)
    if ok:
        dev = root_board.get_device()
        lead = tuple(root_board.shape[:-1])
        E = lead[0] if lead else 1
        n = root_board.shape[-1]
        rows, C = tree.children.shape[-2:]
        row = (*lead, rows)
        W = noise_keys.shape[-2]
        ok = (1 <= n <= MAX_CELLS and rows >= 2 and W >= 1 and E >= 1
              and _fits(root_board, (*lead, n), torch.int8, dev)
              and _fits(tree.children, (*lead, rows, C), torch.int32, dev)
              and _fits(tree.n_children, row, torch.int32, dev)
              and _fits(tree.wins, row, torch.float32, dev)
              and _fits(tree.visits, row, torch.float32, dev)
              and _fits(tree.vloss, row, torch.float32, dev)
              and _fits(tree.move, row, torch.int32, dev)
              and _fits(tree.to_move, row, torch.int32, dev)
              and _fits(noise_keys, (*lead, W, 2), torch.int64, dev))
    if not ok:   # one condition; the message only on failure
        _refuse(tree, root_board, noise_keys, max_depth)
    i32 = dict(dtype=torch.int32, device=root_board.device)
    paths = torch.empty((*lead, W, max_depth), **i32)
    depths, leaves, n_empty = torch.empty((3, *lead, W), **i32)
    boards = torch.empty((*lead, W, n), dtype=torch.int8,
                         device=root_board.device)
    err = _launch.call(_launch.pack(
        tree.children.data_ptr(), tree.n_children.data_ptr(),
        tree.wins.data_ptr(), tree.visits.data_ptr(), tree.vloss.data_ptr(),
        tree.move.data_ptr(), tree.to_move.data_ptr(), root_board.data_ptr(),
        noise_keys.data_ptr(), float(cp), float(noise_scale), int(max_depth),
        E, W, C, n, rows - 1, paths.data_ptr(), depths.data_ptr(),
        leaves.data_ptr(), n_empty.data_ptr(), boards.data_ptr(),
        _build.stream_on(dev)))
    if err != 0:
        raise RuntimeError(
            f"select_descent: kernel launch failed (CUDA error {err})")
    select_descent.launches += 1
    return paths, depths, leaves, boards, n_empty


select_descent.launches = 0  # kernel launches made by this wrapper
