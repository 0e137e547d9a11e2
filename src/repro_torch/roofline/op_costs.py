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
is the step's own, and ``while_trips`` stays empty. One card has no
collectives: the ``coll_*`` fields are 0.

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

import dataclasses
import functools
import types
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _autograd, ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import _plain as _flash_plain

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
        if isinstance(tree, torch.Tensor):
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
        return super().__enter__()

    def __exit__(self, *exc):
        ops._costs = self._prev_costs
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
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
        self.bytes += b
        if self._in_kernel:
            return out          # charged as the kernel, in _kernel_call
        self.bytes_major += b
        elems = sum(t.numel() for t in outs)
        if name in _MATMUL:
            f = _matmul_flops(name, args, outs[0])
            self.flops += f
            self.matmul_flops += f
        else:
            self.flops += elems
            if name in _TRANSCENDENTAL:
                self.transcendentals += elems
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
        self.kernel_calls[name] += 1

        def kernel(*xs):
            self._in_kernel += 1
            try:
                out = plain(*xs)
            finally:
                self._in_kernel -= 1
            self.bytes_major += sum(_nbytes(t) for t in xs) + _nbytes(out)
            self.flops += n_ops
            self.transcendentals += n_transcendental
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

    def rollup(self) -> ModuleCosts:
        return ModuleCosts(flops=self.flops,
                           transcendentals=self.transcendentals,
                           bytes=self.bytes, bytes_major=self.bytes_major,
                           coll_wire=0.0, coll_operand=0.0, coll_count=0.0,
                           coll_by_op={}, while_trips=[])
