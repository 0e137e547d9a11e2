"""Int8 gradient compression for the cross-pod all-reduce (port of
``repro.optim.compression``).

The pod axis of the multi-pod mesh carries one collective: the
data-parallel gradient reduction, over the slowest link. So it is
compressed: block-wise int8 quantization (a float32 scale a block of
``BLOCK`` values, the block's largest magnitude over 127), an all-gather of
the int8 payload and of the scales over the pod axis, and a local
dequantize-and-sum. On the wire that is 1 byte an element a peer against
~2 for a bf16 ring all-reduce, plus 4 / ``BLOCK`` for the scales. The error
of a quantized element is at most half a step, its block's largest
magnitude over 254.

The quantization is the reference's bit for bit, on the CPU and on the
card: ``torch.round`` rounds half to even as ``jnp.round`` does, and both
divides (the scale by 127, the values by ``max(scale, 1e-30)``) are true
float32 divisions. (XLA's CPU backend flushes subnormals to zero, the port
does not: a block whose largest magnitude is subnormal is the one
exception, below the smallest normal float.)

``compressed_psum`` runs on one rank's tensor: the all-gathers go over the
pod sub-group of a ``DeviceMesh`` (``mesh.get_group(axis_name)``), which is
where the reference's ``shard_map`` manual over ``pod`` puts them; the sum
over the gathered payloads is float32, in pod order. In a sharded step
(``train.step.make_train_step_compressed``) each pod's gradient is a
DTensor split over the pod's ranks: the blocks stay the whole gradient's,
so that the quantization is the reference's element for element, while
every rank sends only its own elements, and its peers in the other pods
hold the same elements of theirs.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import tree_map

BLOCK = 1024


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % mult))


def _scale(top: torch.Tensor) -> torch.Tensor:
    """A block's largest magnitude over 127, divided: PyTorch's CUDA
    divide by a Python number multiplies by its reciprocal, which rounds
    differently from the reference's division."""
    return top / torch.full_like(top, 127.0)


def quantize_int8(x: torch.Tensor, block: int = BLOCK):
    """Flatten -> (nblocks, block) int8 and (nblocks, 1) float32 scales."""
    flat = _pad_to(x.to(torch.float32), block).reshape(-1, block)
    scale = _scale(flat.abs().amax(dim=1, keepdim=True))
    q = torch.round(flat / torch.clamp(scale, min=1e-30)).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    flat = q.to(torch.float32) * scale
    n = 1
    for s in shape:
        n *= s
    return flat.reshape(-1)[:n].reshape(shape).to(dtype)


def compressed_psum(x: torch.Tensor, axis_name: str, block: int = BLOCK, *,
                    mesh) -> torch.Tensor:
    """The sum of ``x`` over ``axis_name`` of ``mesh`` (a ``DeviceMesh``)
    with int8 on the wire: every rank of the axis quantizes its ``x``, the payloads and
    scales are all-gathered over the axis's group, and each rank adds the
    dequantized payloads in rank order (the same float32 sum on every
    rank). Equal to the exact sum up to the quantization error.

    ``x`` may be a DTensor on a mesh of the other axes (a pod's gradient,
    sharded within the pod): its blocks are then the whole tensor's, as in
    the reference, each block's scale from the largest magnitude over the
    ranks that hold a part of it (an all-reduce of one float a block); each
    rank quantizes, sends and sums only its own elements, and the result
    is a DTensor with ``x``'s placements."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    if isinstance(x, DTensor):
        return _psum_blocks(x, group, block)
    n = dist.get_world_size(group)
    q, scale = quantize_int8(x, block)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale, group=group)
    total = qs[0].to(torch.float32) * ss[0]
    for qp, sp in zip(qs[1:], ss[1:]):
        total = total + qp.to(torch.float32) * sp
    return total.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)


def _block_ids(x: DTensor, block: int) -> torch.Tensor:
    """The whole tensor's block index (its flat index // ``block``) of each
    of this rank's elements of ``x`` (even splits, major to minor in mesh
    order, as ``sharding.rules.local_slices``)."""
    mesh, local = x.device_mesh, x.to_local()
    coord = mesh.get_coordinate()
    flat = torch.zeros((), dtype=torch.int64, device=local.device)
    stride = 1
    for d in reversed(range(x.dim())):
        idx, parts = 0, 1
        for i, p in enumerate(x.placements):
            if p.is_shard(d):
                idx = idx * mesh.size(i) + coord[i]
                parts *= mesh.size(i)
        n = local.shape[d]
        pos = torch.arange(n, device=local.device) + idx * (x.shape[d]
                                                           // parts)
        flat = flat + (pos * stride).reshape((n,) + (1,) * (x.dim() - 1 - d))
        stride *= x.shape[d]
    return (flat // block).expand(local.shape)


def _psum_blocks(x: DTensor, group, block: int) -> DTensor:
    import torch.distributed as dist

    local = x.to_local().to(torch.float32)
    bid = _block_ids(x, block)
    nblocks = -(-x.numel() // block)
    top = torch.zeros(nblocks, dtype=torch.float32, device=local.device)
    top.scatter_reduce_(0, bid.reshape(-1), local.abs().reshape(-1), "amax")
    for i in range(x.device_mesh.ndim):
        dist.all_reduce(top, op=dist.ReduceOp.MAX,
                        group=x.device_mesh.get_group(i))
    scale = _scale(top)
    q = torch.round(local / torch.clamp(scale, min=1e-30)[bid]).to(torch.int8)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale, group=group)
    total = qs[0].to(torch.float32) * ss[0][bid]
    for qp, sp in zip(qs[1:], ss[1:]):
        total = total + qp.to(torch.float32) * sp[bid]
    return DTensor.from_local(total.to(x.dtype), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def compressed_psum_tree(tree: dict, axis_name: str, block: int = BLOCK, *,
                         mesh) -> dict:
    """``compressed_psum`` of every leaf of a nested dict, in the dict's
    own order (the same on every rank: each leaf's gathers are issued in
    the same order everywhere)."""
    return tree_map(lambda g: compressed_psum(g, axis_name, block, mesh=mesh),
                    tree)
