"""Per-op cost count of a step run on ``meta`` tensors: the port's
counterpart of ``repro.roofline.hlo_costs``.

The JAX package parses the compiled HLO of a cell; the port has no HLO.
Instead ``OpCosts``, a ``TorchDispatchMode``, sees every aten op the step
dispatches — the forward, autograd's backward and the optimizer — and
charges each one under ``hlo_costs``' conventions:

    flops:  a matmul-class op (mm, bmm, addmm, baddbmm, mv, dot — einsum
            and matmul arrive as these — and convolution) costs
            2 * result elements * contracted size (+ the result's elements
            for the fused add of addmm / baddbmm); any other op costs its
            result's elements, transcendentals (exp, log, tanh, rsqrt, ...)
            also counted apart
    bytes:  result + operands (an in-place copy or fill does not read
            what it overwrites); a view, an ``empty`` and a metadata query
            cost nothing; a gather (index_select, embedding, advanced
            indexing) costs twice its result and a scatter or an in-place
            indexed write (a cache write) twice its updates (+ the result
            when out of place): slice size, never the whole operand

Python loops run in full, so there are no loop trips to scale: every count
is the step's own, and ``while_trips`` stays empty — save one: a token
recurrence (``kernels.ops.token_loop``, the sLSTM's in ``models/xlstm.py``)
is charged one token step times its trip count, as ``hlo_costs`` scales a
while body (``token_loop``, ``scaled_step``).

**One rank's share** (a sharded step, ``launch.dryrun``'s ``single`` and
``multipod`` meshes): the step runs on DTensors whose local shards are
``meta``. An op on DTensors is handed back to DTensor (``NotImplemented``),
which runs the rank's local op — charged here as any op — and the
collectives its redistributions need, each recorded by
``roofline.collectives.record_collective`` (count, operand and wire bytes,
and ``2 x result`` bytes, as ``hlo_costs`` charges one). DTensor's sharding
propagation also runs each op once on fake tensors of the GLOBAL shapes to
learn the output's shape; those runs are not the rank's program and are
neither charged nor held live. On a CPU mesh DTensor swaps an all-to-all
for an all-gather and a local chunk (gloo has no all-to-all): the swap is
recorded as the one all-to-all it stands for. One card has no collectives:
the ``coll_*`` fields are 0.

``bytes`` is the eager upper bound: every op's result and operands, the
hand-written kernels' plain bodies included. ``bytes_major`` charges each
call of ``kernels.ops.flash_attention`` and ``kernels.ops.rmsnorm`` the
bytes the kernel itself moves — its inputs read once, its output written
once (q, k, v, o; x, w, y), the formulas of PERF.md's bound column — in
place of its plain body's, and ``flops`` charges it the kernel's own
operations (flash: the causal pairs only). While a count runs,
``kernels.ops`` sends those two calls here (``ops._costs``; one module
attribute read when no count runs): the plain body computes the ``meta``
result, and under autograd the call goes through ``kernels._autograd.
KernelFn`` as on the card, so the backward recomputes the plain version
and differentiates it, op by op.

**Peak memory**, the counterpart of ``compiled.memory_analysis()``: the
largest total of live storages over the run. Each storage is registered
when an op first returns it (or by ``track`` for the step's inputs) and
released when its last tensor dies (``weakref.finalize`` on the storage,
which PyTorch keeps alive as long as any tensor, view or saved tensor uses
it). A kernel call's plain body allocates nothing here but the output, as
the kernel does.

Use::

    with OpCosts() as oc:
        oc.track(state, batch)
        step(state, batch)
    costs = oc.rollup()          # ModuleCosts: flops, bytes, ...
    oc.peak_bytes, oc.kernel_calls
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import types
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _autograd, ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import _plain as _flash_plain
from repro_torch.roofline import collectives as coll

# ops that move no data and do no arithmetic (views are found by schema)
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "_unsafe_view",
         "_local_scalar_dense"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot",
           "convolution"}
_FUSED_ADD = {"addmm", "baddbmm", "addbmm"}
_TRANSCENDENTAL = {"exp", "exp_", "exp2", "expm1", "log", "log_", "log2",
                   "log10", "log1p", "tanh", "tanh_", "rsqrt", "rsqrt_",
                   "sqrt", "sqrt_", "pow", "pow_", "sigmoid", "sigmoid_",
                   "sin", "cos", "erf", "erfc", "atan2", "softplus", "silu",
                   "silu_", "silu_backward", "gelu", "gelu_backward",
                   "softplus_backward", "_softmax", "_log_softmax",
                   "logsumexp", "logit", "log_sigmoid_forward",
                   "log_sigmoid_backward"}
# gathers: twice the result (read the slice, write it)
_GATHER = {"index_select", "gather", "index", "embedding", "take",
           "masked_select"}
# in-place writes that do not read what they overwrite: the result and the
# other operands
_OVERWRITE = {"copy_", "fill_", "zero_"}
# scatters and indexed writes: the operand position of their updates
_SCATTER = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
            "scatter_reduce": 3, "scatter_reduce_": 3, "index_add": 3,
            "index_add_": 3, "index_copy": 3, "index_copy_": 3,
            "slice_scatter": 1, "select_scatter": 1,
            "embedding_dense_backward": 0}


@dataclasses.dataclass
class ModuleCosts:
    flops: float
    transcendentals: float
    bytes: float          # eager upper bound (the kernels' plain bodies)
    bytes_major: float    # each kernel call at the bytes the kernel moves
    coll_wire: float
    coll_operand: float
    coll_count: float
    coll_by_op: dict
    while_trips: list

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def leaf_tensors(*trees):
    """The tensors of nested dicts, lists and tuples (a ``TransformerLM`` by
    its tree)."""
    for tree in trees:
        if isinstance(tree, DTensor):
            yield tree.to_local()
        elif isinstance(tree, torch.Tensor):
            yield tree
        elif isinstance(tree, dict):
            yield from leaf_tensors(*tree.values())
        elif isinstance(tree, (list, tuple)):
            yield from leaf_tensors(*tree)
        elif hasattr(tree, "tree"):
            yield from leaf_tensors(tree.tree())


def storages(*trees) -> dict[int, int]:
    """{storage id: bytes} of the distinct storages under ``trees``."""
    return {id(s): s.nbytes() for s in
            (t.untyped_storage() for t in leaf_tensors(*trees))}


def _sharding_propagation(out) -> bool:
    """Whether an op ran inside DTensor's sharding propagation (on fake
    tensors of the global shapes, to learn the output's shape): its result
    is fake."""
    if isinstance(out, (tuple, list)) and out:
        out = out[0]
    return isinstance(out, FakeTensor)


def _matmul_flops(name: str, args, out: torch.Tensor) -> float:
    if name == "convolution":
        w = args[1]
        return 2.0 * out.numel() * (w.numel() // w.shape[0])
    if name in ("addmm", "baddbmm"):
        a = args[1]
    elif name == "addbmm":      # the batch of products summed into one
        a = args[1]
        return 2.0 * a.shape[0] * out.numel() * a.shape[-1] + out.numel()
    else:
        a = args[0]
    flops = 2.0 * out.numel() * a.shape[-1]
    return flops + (out.numel() if name in _FUSED_ADD else 0)


class OpCosts(TorchDispatchMode):
    """The count of one run (module docstring). ``kernel_calls`` and
    ``plain_backwards`` count, per kernel, the calls the card would launch
    and the backwards through their plain versions."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.matmul_flops = 0.0       # the matmul-class ops' share of flops
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.bytes_major = 0.0
        self.kernel_calls = {"flash_attention": 0, "rmsnorm": 0}
        # KernelFn's ``wrapper`` argument: counts the plain backwards here,
        # not in the card's kernel counters
        self._backwards = {name: types.SimpleNamespace(plain_backwards=0)
                           for name in self.kernel_calls}
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._in_kernel = 0
        self._prev_costs = None
        self.collectives: list[coll.Collective] = []
        self._in_alltoall = 0
        self._scale = 1             # the trip count of a scaled loop body
        self.while_trips: list[int] = []
        self._patched = None

    @property
    def plain_backwards(self) -> dict:
        return {k: v.plain_backwards for k, v in self._backwards.items()}

    # ------------------------------------------------------------ memory ----
    def track(self, *trees) -> None:
        """Register the storages of the step's inputs (``leaf_tensors``) as
        live."""
        for t in leaf_tensors(*trees):
            self._register(t)

    def _register(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -------------------------------------------------------- dispatching ----
    def __enter__(self):
        self._prev_costs, ops._costs = ops._costs, self
        self._patch_alltoall()
        return super().__enter__()

    def __exit__(self, *exc):
        ops._costs = self._prev_costs
        if self._patched is not None:
            mod, fn = self._patched
            mod.shard_dim_alltoall = fn
            self._patched = None
        return super().__exit__(*exc)

    def _patch_alltoall(self) -> None:
        """Record DTensor's shard-to-shard all-to-all as one ``all-to-all``
        of its result, whatever it runs as (on a CPU mesh an all-gather and
        a chunk)."""
        from torch.distributed.tensor import placement_types as pt

        fn = getattr(pt, "shard_dim_alltoall", None)
        if fn is None:
            return

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._in_alltoall += 1
            try:
                out = fn(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._in_alltoall -= 1
            if self._in_alltoall == 0:
                self._collective(coll.Collective(
                    "all-to-all", _nbytes(out), mesh.size(mesh_dim)), out)
            return out

        self._patched = (pt, fn)
        pt.shard_dim_alltoall = alltoall

    @contextlib.contextmanager
    def _scaled_loop(self, trips: int):
        """Charge what runs inside ``trips`` times: one step of a loop
        standing for all of its steps, as ``hlo_costs`` multiplies a while
        body by its trip count (recorded in ``while_trips``)."""
        prev = self._scale
        self._scale = prev * int(trips)
        self.while_trips.append(int(trips))
        try:
            yield
        finally:
            self._scale = prev

    @contextlib.contextmanager
    def held(self, t: torch.Tensor, n: int):
        """Hold ``n`` more storages of ``t``'s size live while the block
        runs: the tensors a full loop would keep that one scaled step
        stands for."""
        extra = n * t.untyped_storage().nbytes() * self._scale
        self.live_bytes += extra
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        try:
            yield
        finally:
            self.live_bytes -= extra

    def scaled_step(self, trips: int, step, inputs, *args):
        """``step(*args)`` as one step standing for ``trips``: its ops are
        charged ``trips`` times; under autograd so is its backward (each
        backward node of the step runs at the same scale), and the tensors
        the step keeps for it are held ``trips`` times over until the
        backward reaches the step. ``inputs`` are the tensors from outside
        the step that it reads (where its graph stops)."""
        before = self.live_bytes
        with self._scaled_loop(trips):
            out = step(*args)
        outs = [t for t in leaf_tensors(out) if t.grad_fn is not None]
        if not outs:
            return out
        extra = (self.live_bytes - before) * (trips - 1)
        self.live_bytes += extra
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        outside = {t.grad_fn for t in leaf_tensors(inputs)} | {None}
        nodes, todo = set(), [t.grad_fn for t in outs]
        while todo:
            n = todo.pop()
            if n in outside or n in nodes or type(n).__name__ == \
                    "AccumulateGrad":
                continue
            nodes.add(n)
            todo.extend(f for f, _ in n.next_functions)
        prev = []
        held = [extra]

        def pre(grad_outputs):
            if held[0]:
                self.live_bytes -= held[0]
                held[0] = 0
            prev.append(self._scale)
            self._scale = prev[-1] * int(trips)

        def post(grad_inputs, grad_outputs):
            self._scale = prev.pop()

        for n in nodes:
            n.register_prehook(pre)
            n.register_hook(post)
        return out

    def _collective(self, c: coll.Collective, out) -> None:
        """Charge one collective: recorded, and its result's bytes read and
        written (``hlo_costs``' ``2 x result``)."""
        self.collectives.extend([c] * self._scale)
        self.bytes += 2 * c.result_bytes * self._scale
        self.bytes_major += 2 * c.result_bytes * self._scale
        for t in leaf_tensors(out):
            self._register(t)

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types_):
            return NotImplemented       # DTensor runs the rank's local ops
        out = func(*args, **kwargs)
        if self._in_alltoall or _sharding_propagation(out):
            return out
        name = func.overloadpacket.__name__
        if func.namespace in coll.NAMESPACES:
            c = coll.record_collective(func, args, out)
            if c is not None:
                self._collective(c, out)
            return out
        if func.is_view or name in _FREE:
            return out
        outs = list(leaf_tensors(out))
        out_bytes = sum(_nbytes(t) for t in outs)
        if name in _GATHER:
            b = 2 * out_bytes
        elif name in _SCATTER:
            upd = args[_SCATTER[name]] if len(args) > _SCATTER[name] else None
            ub = _nbytes(upd) if isinstance(upd, torch.Tensor) else 0
            b = 2 * ub + (0 if name.endswith("_") else out_bytes)
        elif name in _OVERWRITE:
            b = out_bytes + sum(_nbytes(t) for t in leaf_tensors(args[1:]))
        else:
            b = out_bytes + sum(_nbytes(t) for t in leaf_tensors(args, kwargs))
        k = self._scale
        self.bytes += b * k
        if self._in_kernel:
            return out          # charged as the kernel, in _kernel_call
        self.bytes_major += b * k
        elems = sum(t.numel() for t in outs)
        if name in _MATMUL:
            f = _matmul_flops(name, args, outs[0])
            self.flops += f * k
            self.matmul_flops += f * k
        else:
            self.flops += elems * k
            if name in _TRANSCENDENTAL:
                self.transcendentals += elems * k
        for t in outs:
            self._register(t)
        return out

    # ------------------------------------------------------------ kernels ----
    def _kernel_call(self, name: str, plain, inputs, n_ops: float,
                     n_transcendental: float):
        """One kernel call: ``plain`` computes the result with nothing
        charged but its eager bytes; the kernel's bytes, operations and
        output are charged instead. Under autograd through ``KernelFn``,
        as on the card."""
        self.kernel_calls[name] += self._scale

        def kernel(*xs):
            self._in_kernel += 1
            try:
                out = plain(*xs)
            finally:
                self._in_kernel -= 1
            k = self._scale
            self.bytes_major += (sum(_nbytes(t) for t in xs)
                                 + _nbytes(out)) * k
            self.flops += n_ops * k
            self.transcendentals += n_transcendental * k
            self._register(out)
            return out

        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            return _autograd.KernelFn.apply(kernel, plain,
                                            self._backwards[name], *inputs)
        return kernel(*inputs)

    def rmsnorm(self, x, w, eps: float, order: str):
        """``kernels.ops.rmsnorm`` under the count: 4 operations an element
        (square, add, scale, weight), one rsqrt a row."""
        plain = functools.partial(_ref.rmsnorm, eps=eps, order=order)
        rows = x.numel() // x.shape[-1] if x.dim() else 1
        return self._kernel_call("rmsnorm", plain, (x, w), 4 * x.numel(), rows)

    def flash_attention(self, q, k, v, causal: bool, scale, layout: str):
        """``kernels.ops.flash_attention`` under the count: the two products
        over the attended pairs (the causal ones when ``causal``), one exp a
        pair."""
        plain = functools.partial(_flash_plain, causal=causal, scale=scale,
                                  layout=layout)
        S = q.shape[1] if layout == "bshd" else q.shape[2]
        d = q.shape[-1]
        rows = q.numel() // (S * d)                  # B * H
        pairs = S * (S + 1) // 2 if causal else S * S
        return self._kernel_call("flash_attention", plain, (q, k, v),
                                 4 * rows * pairs * d, rows * pairs)

    def token_loop(self, step, trips: int, state: tuple, inputs):
        """``kernels.ops.token_loop`` under the count: one step run and
        charged ``trips`` times (``scaled_step``), and its output held
        ``trips - 1`` times more while they are stacked, as the full loop
        keeps every step's."""
        y, state = self.scaled_step(trips, step, (inputs, state), 0, state)
        with self.held(y, trips - 1):
            ys = torch.stack([y] * trips, dim=1)
        return ys, state

    def rollup(self) -> ModuleCosts:
        """The totals; ``coll_by_op`` is ``hlo_costs``' {op: [count, wire
        bytes]}."""
        summ = coll.summarize(self.collectives)
        return ModuleCosts(flops=self.flops,
                           transcendentals=self.transcendentals,
                           bytes=self.bytes, bytes_major=self.bytes_major,
                           coll_wire=float(summ["wire_bytes"]),
                           coll_operand=float(summ["operand_bytes"]),
                           coll_count=float(summ["count"]),
                           coll_by_op={op: [e["count"], e["wire_bytes"]]
                                       for op, e in summ["by_op"].items()},
                           while_trips=list(self.while_trips))
