"""Gradients through the hand-written kernels' wrappers
(``kernels._autograd.KernelFn``): the kernel's forward, the plain
version's backward. The kernels cannot run here, so the backward is held
with a stand-in forward — the plain version itself — against autograd
through the plain version: equal, for both rounding orders of rmsnorm and
both layouts and both dtypes of flash attention. On a machine without
CUDA, a wrapper asked for a gradient still dispatches to its kernel, which
raises, and no plain forward runs."""

import functools

import pytest
import torch

from repro_torch.kernels import _autograd, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn

torch.set_num_threads(1)


def _grads_both_ways(plain, wrapper, inputs):
    """(grads through KernelFn with ``plain`` as the forward, grads of
    ``plain`` itself), for one cotangent; the outputs must be equal too."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    ys = [t.detach().clone().requires_grad_(True) for t in inputs]
    before = wrapper.plain_backwards
    out = _autograd.KernelFn.apply(plain, plain, wrapper, *xs)
    want = plain(*ys)
    assert torch.equal(out, want)
    g = torch.Generator().manual_seed(1)
    cot = torch.randn(out.shape, generator=g).to(out.dtype)
    got = torch.autograd.grad(out, xs, cot)
    ref_grads = torch.autograd.grad(want, ys, cot)
    assert wrapper.plain_backwards == before + 1
    return got, ref_grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["kernel", "model"])
def test_rmsnorm_backward_is_the_plain_versions(order, dtype):
    g = torch.Generator().manual_seed(0)
    x = (3 * torch.randn(2, 5, 64, generator=g)).to(dtype)
    w = (1 + 0.1 * torch.randn(64, generator=g)).to(dtype)
    plain = functools.partial(ref.rmsnorm, eps=1e-5, order=order)
    got, want = _grads_both_ways(plain, rn.rmsnorm, (x, w))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_attention_backward_is_the_plain_versions(layout, dtype):
    g = torch.Generator().manual_seed(2)
    B, H, Hkv, S, d = 2, 4, 2, 9, 16
    shape = (lambda h: (B, S, h, d)) if layout == "bshd" else (
        lambda h: (B, h, S, d))
    q, k, v = (torch.randn(shape(h), generator=g).to(dtype)
               for h in (H, Hkv, Hkv))
    plain = functools.partial(fa._plain, causal=True, scale=None,
                              layout=layout)
    got, want = _grads_both_ways(plain, fa.flash_attention, (q, k, v))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_kernel_fn_returns_none_for_inputs_without_grad():
    x = torch.randn(3, 8, requires_grad=True)
    w = torch.randn(8)
    plain = functools.partial(ref.rmsnorm, eps=1e-5, order="model")
    out = _autograd.KernelFn.apply(plain, plain, rn.rmsnorm, x, w)
    (gx,) = torch.autograd.grad(out.sum(), [x])
    want = torch.autograd.grad(plain(x, w).sum(), [x])[0]
    assert torch.equal(gx, want)


def _count_plain(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def test_wrappers_asked_for_grad_dispatch_to_the_kernel(monkeypatch):
    """Without CUDA: the wrapper, given CPU tensors that require grad,
    still goes to its kernel (which refuses CPU tensors) — never to a plain
    forward."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule is checked where it "
                    "has none")
    norm_calls = _count_plain(monkeypatch, rn, "rmsnorm_plain")
    flash_calls = _count_plain(monkeypatch, fa, "flash_attention_plain")
    x = torch.randn(2, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    launches = rn.rmsnorm.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        rn.rmsnorm(x, w, 1e-5, order="model")
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q, layout="bshd")
    assert norm_calls == [] and flash_calls == []
    assert rn.rmsnorm.launches == launches
    # under no_grad the same call takes the host path, and refuses alike
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        rn.rmsnorm(x, w, 1e-5, order="model")


def test_ops_on_cpu_tensors_stay_on_the_plain_versions_under_grad():
    """The dispatch rule is unchanged: a CPU tensor goes to the plain
    version, with or without grad, and differentiates through it."""
    x = torch.randn(2, 3, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    out = ops.rmsnorm(x, w, 1e-5, order="model")
    assert out.grad_fn is not None
    (gx,) = torch.autograd.grad(out.sum(), [x])
    assert torch.isfinite(gx).all()
