"""The collectives of one rank's sharded step, and their wire bytes (port of
``repro.roofline.collectives``).

The JAX package regexes the compiled SPMD module for its collective
instructions. The port has no HLO: a sharded step runs one rank's share
under DTensor, and every collective DTensor issues is a dispatched op
(``_c10d_functional.all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``, or DTensor's own
``_dtensor.shard_dim_alltoall``), which ``roofline.op_costs.OpCosts``
hands to ``record_collective``. Each becomes
a ``Collective`` by the reference's conventions — its RESULT's bytes (the
gathered tensor of an all-gather, the scattered one of a reduce-scatter)
and its group's size, read from the call's group name — and is reckoned by
the reference's ring model:

    op                  operand_bytes        wire_bytes (ring model)
    all-reduce          result               2 (G-1)/G * result
    all-gather          result / G           (G-1)/G * result
    reduce-scatter      result * G           (G-1)/G * result * G
    all-to-all          result               (G-1)/G * result
    collective-permute  result               result

The ``Collective`` table and ``summarize`` are the reference's, copied;
this module imports no JAX.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class Collective:
    op: str
    result_bytes: int
    group_size: int

    @property
    def operand_bytes(self) -> int:
        if self.op == "all-gather":
            return self.result_bytes // max(self.group_size, 1)
        if self.op == "reduce-scatter":
            return self.result_bytes * self.group_size
        return self.result_bytes

    @property
    def wire_bytes(self) -> float:
        g = max(self.group_size, 1)
        if self.op == "all-reduce":
            return 2.0 * (g - 1) / g * self.result_bytes
        if self.op == "all-gather":
            return (g - 1) / g * self.result_bytes
        if self.op == "reduce-scatter":
            return (g - 1) / g * self.result_bytes * g
        if self.op == "all-to-all":
            return (g - 1) / g * self.result_bytes
        return float(self.result_bytes)  # collective-permute


# the dispatched collectives: (namespace, op) -> (the reference's op name,
# the position of the group-name argument)
_OPS = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", 2),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 2),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 3),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 3),
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", 3),
}
# bookkeeping ops of the functional collectives: no data moves
FREE = {"wait_tensor", "_wrap_tensor_autograd"}
NAMESPACES = {"_c10d_functional", "_c10d_functional_autograd", "c10d",
              "_dtensor"}


def group_size(group_name: str) -> int:
    """The size of a process group given by name (a functional
    collective's argument)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    return dist.get_world_size(c10d._resolve_process_group(group_name))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def record_collective(func, args, out) -> Collective | None:
    """The ``Collective`` of one dispatched op of a collective namespace
    (``NAMESPACES``): its result's bytes and its group's size; ``None`` for
    an op that moves nothing. A collective not in ``_OPS`` raises: it would
    go uncounted."""
    name = func.overloadpacket.__name__
    key = (func.namespace, name)
    if name in FREE or (key not in _OPS and func.namespace == "_dtensor"):
        return None                 # (DTensor's other ops move nothing)
    if key not in _OPS:
        raise NotImplementedError(f"collective {func} is not recorded "
                                  "(roofline.collectives._OPS)")
    op, g_arg = _OPS[key]
    return Collective(op, _nbytes(out), group_size(args[g_arg]))


def summarize(colls: list[Collective]) -> dict:
    by_op: dict[str, dict] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0, "wire_bytes": 0.0})
    for c in colls:
        e = by_op[c.op]
        e["count"] += 1
        e["operand_bytes"] += c.operand_bytes
        e["wire_bytes"] += c.wire_bytes
    return {
        "by_op": dict(by_op),
        "count": len(colls),
        "operand_bytes": sum(c.operand_bytes for c in colls),
        "wire_bytes": sum(c.wire_bytes for c in colls),
    }
