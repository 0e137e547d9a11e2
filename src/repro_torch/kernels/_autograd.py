"""Gradients through the hand-written kernels: the kernel's forward, the
plain version's backward.

The TPU kernels have no backward: the JAX package differentiates its models
through the jnp functions the kernels stand for (``custom_vjp`` appears
nowhere in ``repro.kernels``), so the gradient the port owes is the plain
version's. ``KernelFn`` runs the kernel in the forward and saves its tensor
inputs; its backward recomputes the plain version (``kernels.ref``) on
detached copies under ``torch.enable_grad()`` and returns
``torch.autograd.grad`` of it, the gradient autodiff of the same function
gives. The plain version never runs in the forward: under autograd the
forward stays the kernel, whose wrapper counts it in ``.launches``; each
backward adds one to the wrapper's ``.plain_backwards``.
"""

from __future__ import annotations

import torch


class KernelFn(torch.autograd.Function):
    """``KernelFn.apply(kernel, plain, wrapper, *inputs)``: ``kernel(*inputs)``
    forward, the gradient of ``plain(*inputs)`` backward. ``kernel`` and
    ``plain`` take the same tensors (their other arguments bound already);
    ``wrapper`` is the public function whose ``.plain_backwards`` counts
    the backward's recomputations."""

    @staticmethod
    def forward(ctx, kernel, plain, wrapper, *inputs):
        ctx.plain, ctx.wrapper = plain, wrapper
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*leaves)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], grad_out))
        ctx.wrapper.plain_backwards += 1
        return (None, None, None,
                *(next(grads) if n else None for n in need))
