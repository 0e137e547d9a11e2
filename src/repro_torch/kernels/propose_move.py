"""The move proposal of a sync iteration in one launch: the hand-written
CUDA kernel's wrapper.

Replaces no TPU kernel: the JAX reference's ``propose_move`` is jnp plus
``jax.random.uniform``, which XLA fuses. The port's plain version
(``kernels.ref.propose_move``, the body ``core.gscpm.propose_move`` had)
spends ~200 eager launches a call, ~175 of them on the int64 threefry of
``rng.uniform(key, n)`` over every lane's n cells; in the benchmark's Hex
cell that draw was 78 % of the card's busy time. The kernel is
``propose_move_kernel`` in ``csrc/propose_move.cu``: one warp a lane marks
the leaf's tried moves in a shared bitmask, draws ``threefry::uniform(key,
c)`` (``csrc/threefry.cuh``) only for its untried legal cells, and reduces
the first-index argmax over the warp in registers.

What bounds it on an H100: operations (~123 a uniform) and launch latency;
the bytes are the legal mask, the leaves' child rows and the keys.

The game's legal mask is an input, so the kernel knows no game rule. The
tree's fields and the keys are read in place: the keys through their lane
stride, as the search's move keys are a view of its ``(..., 3, 2)`` key
split. A forest is one launch for all its lanes. ``propose_move_plain``
(``kernels.ref.propose_move``) is the plain PyTorch version;
``kernels.ops.propose_move`` chooses by where the tensors lie.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import propose_move as propose_move_plain  # noqa: F401

MAX_CELLS = 625  # csrc/propose_move.cu: kMaxCells
_launch = _build.Launcher("repro_propose_move")


def _lane_stride(key: torch.Tensor, lead: tuple) -> int | None:
    """Elements between the keys of two consecutive lanes when the lanes
    of ``key`` (``(*lead, 2)``, its two words adjacent) are taken in row
    order, or None when no one stride steps through them. 2 when there is
    one lane."""
    step = None
    span = None
    for size, stride in reversed(list(zip(lead, key.stride()[:-1]))):
        if size == 1:
            continue
        if step is None:
            step = stride
        elif stride != span:
            return None
        span = stride * size
    return 2 if step is None else step


def _check_field(name: str, t, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"propose_move: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"propose_move: {name} on {t.device}, expected "
                         f"{device}")
    if t.dtype != torch.int32:
        raise TypeError(f"propose_move: {name} is {t.dtype}, expected "
                        "torch.int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"propose_move: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"propose_move: {name} must be contiguous")


def _refuse(tree, leaf, legal, key) -> None:
    """Raise the error for arguments the kernel does not take: the first
    wrong type, dtype, shape, device or layout, else the CPU."""
    if not isinstance(legal, torch.Tensor):
        raise TypeError("propose_move: legal must be a tensor")
    dev = legal.device
    if legal.dtype != torch.bool:
        raise TypeError(f"propose_move: legal is {legal.dtype}, expected "
                        "torch.bool")
    if not isinstance(leaf, torch.Tensor) or leaf.device != dev:
        raise ValueError(f"propose_move: leaf must be a tensor on {dev}")
    if leaf.dtype != torch.int32:
        raise TypeError(f"propose_move: leaf is {leaf.dtype}, expected "
                        "torch.int32")
    lead = tuple(leaf.shape)
    if legal.dim() != leaf.dim() + 1 or tuple(legal.shape[:-1]) != lead:
        raise ValueError(
            f"propose_move: legal has shape {tuple(legal.shape)}, expected "
            f"the leaves' shape {lead} and the cells")
    n = legal.shape[-1]
    if not 1 <= n <= MAX_CELLS:
        raise ValueError(f"propose_move: {n} cells outside 1..{MAX_CELLS}")
    if leaf.numel() == 0:
        raise ValueError("propose_move: no lanes")
    if not isinstance(key, torch.Tensor) or key.device != dev:
        raise ValueError(f"propose_move: key must be a tensor on {dev}")
    if key.dtype != torch.int64:
        raise TypeError(f"propose_move: key is {key.dtype}, expected "
                        "torch.int64")
    if tuple(key.shape) != (*lead, 2):
        raise ValueError(
            f"propose_move: key has shape {tuple(key.shape)}, expected "
            f"{(*lead, 2)}: one (k0, k1) pair a lane")
    stride = _lane_stride(key, lead)
    if key.stride(-1) != 1 or stride is None or stride < 2:
        raise ValueError(
            "propose_move: key's two words must be adjacent and its lanes "
            f"one stride of at least 2 apart, got strides {key.stride()}")
    forest = tree.children.dim() == 3
    if tree.children.dim() not in (2, 3):
        raise ValueError("propose_move: children must be (cap + 1, C) or "
                         "(E, cap + 1, C)")
    E = tree.children.shape[0] if forest else 1
    if forest and (leaf.dim() < 1 or leaf.shape[0] != E):
        raise ValueError(
            f"propose_move: a forest of {E} members takes leaves with the "
            f"member axis first, got shape {lead}")
    rows, C = tree.children.shape[-2:]
    if rows < 2:
        raise ValueError("propose_move: children must have cap + 1 >= 2 rows")
    member = (E,) if forest else ()
    _check_field("tree.children", tree.children, (*member, rows, C), dev)
    _check_field("tree.n_children", tree.n_children, (*member, rows), dev)
    _check_field("tree.move", tree.move, (*member, rows), dev)
    for name, t in (("leaf", leaf), ("legal", legal)):
        if not t.is_contiguous():
            raise ValueError(f"propose_move: {name} must be contiguous")
    raise ValueError(
        "propose_move: the kernel takes CUDA tensors; for CPU tensors call "
        "kernels.ops.propose_move (plain version)")


def propose_move(tree, leaf: torch.Tensor, legal: torch.Tensor,
                 key: torch.Tensor) -> torch.Tensor:
    """Per lane, a uniformly random legal cell that the lane's leaf has no
    child for yet, or -1 (``NO_NODE``).

    ``tree``: a ``core.tree.Tree`` (fields (cap + 1[, C])) or a forest of
    E members (fields (E, cap + 1[, C])), read in place. ``leaf``: int32
    member-local leaf ids of any shape, the member axis first on a forest
    (lane l of the N flattened belongs to member l // (N / E)). ``legal``:
    the game's (*leaf.shape, n) bool legal mask of the leaves' boards.
    ``key``: (*leaf.shape, 2) int64 move keys, read through their lane
    stride (a view of a key split is fine). Returns (*leaf.shape) int32,
    bit for bit ``kernels.ref.propose_move``. Launches on the current
    stream."""
    ok = (isinstance(legal, torch.Tensor) and legal.is_cuda
          and legal.dtype == torch.bool and isinstance(leaf, torch.Tensor)
          and isinstance(key, torch.Tensor) and tree.children.dim() in (2, 3)
          and legal.dim() == leaf.dim() + 1 and key.dim() == leaf.dim() + 1)
    if ok:
        dev = legal.get_device()
        lead = tuple(leaf.shape)
        n = legal.shape[-1]
        children = tree.children
        forest = children.dim() == 3
        E = children.shape[0] if forest else 1
        rows, C = children.shape[-2:]
        row = (E, rows) if forest else (rows,)
        N = leaf.numel()
        stride = _lane_stride(key, lead)
        ok = (1 <= n <= MAX_CELLS and N >= 1 and rows >= 2
              and (not forest or (lead and lead[0] == E))
              and tuple(legal.shape[:-1]) == lead
              and tuple(key.shape) == (*lead, 2)
              and leaf.dtype == torch.int32 and key.dtype == torch.int64
              and leaf.get_device() == dev and key.get_device() == dev
              and leaf.is_contiguous() and legal.is_contiguous()
              and key.stride(-1) == 1 and stride is not None and stride >= 2
              and children.dtype == torch.int32 and children.is_contiguous()
              and children.get_device() == dev
              and all(t.dtype == torch.int32 and t.shape == row
                      and t.get_device() == dev and t.is_contiguous()
                      for t in (tree.n_children, tree.move)))
    if not ok:   # one condition; the message only on failure
        _refuse(tree, leaf, legal, key)
    out = torch.empty(lead, dtype=torch.int32, device=legal.device)
    err = _launch.call(_launch.pack(
        children.data_ptr(), tree.n_children.data_ptr(),
        tree.move.data_ptr(), leaf.data_ptr(), legal.data_ptr(),
        key.data_ptr(), stride, N, E, rows, C, n, out.data_ptr(),
        _build.stream_on(dev)))
    if err != 0:
        raise RuntimeError(
            f"propose_move: kernel launch failed (CUDA error {err})")
    propose_move.launches += 1
    return out


propose_move.launches = 0  # kernel launches made by this wrapper
