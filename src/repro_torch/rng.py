"""Counter-based RNG: threefry2x32 keys, bit-identical to ``jax.random``.

The search's invariants (a round's streams depend only on ``(key,
task_ids)``; scalar oracles and batched paths share streams) need a
generator whose output is a pure function of a key, so the port's explicit
generator is an explicit *key tensor*, not a stateful ``torch.Generator``.

A key is a ``(..., 2)`` int64 tensor holding two uint32 words. Every
function is batched over the leading axes and reproduces, bit for bit, what
``jax.random`` computes for typed keys (``jax.random.key``) under the
partitionable threefry implementation:

- ``key(seed)``        -> words ``(0, seed)``
- ``fold_in(k, d)``    -> ``threefry(k, counter=(0, d))``
- ``split(k, n)``      -> ``threefry(k, counter=(0, iota n))`` stacked
- ``uniform(k, n)``    -> 32 random bits per element are ``out0 ^ out1`` of
  ``threefry(k, counter=(0, iota n))``; the float is
  ``bitcast_f32((bits >> 9) | 0x3F800000) - 1`` in ``[0, 1)``
- ``gumbel(k, n)``, ``categorical(k, logits)`` -> built on ``uniform`` as
  ``jax.random`` builds them (the float ``log`` is the only place where the
  two may part, by an ulp)

All arithmetic is on int64 tensors masked to 32 bits (torch has no uint32
arithmetic); everything is elementwise, so the same code runs on CPU and
CUDA tensors and gives the same bits on both.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds. ``key`` is (..., 2); ``x0``/``x1`` are
    counter words broadcastable against ``key[..., 0]``. Returns the two
    output words as int64 tensors of uint32 values."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _MASK
            # rotl32: the high spill of the left shift is cut by the mask
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """A fresh key from an integer seed (``jax.random.key(seed)``)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold integer ``data`` into ``key``; batched: ``key`` (..., 2) and
    ``data`` (...) broadcast against each other."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    zero = torch.zeros_like(d)
    o0, o1 = threefry2x32(key, zero, d)
    return torch.stack([o0, o1], dim=-1)


def _counters(key: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return torch.zeros_like(lo), lo


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``n`` independent keys per input key: (..., 2) -> (..., n, 2)."""
    hi, lo = _counters(key, n)
    o0, o1 = threefry2x32(key[..., None, :], hi, lo)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) int64 tensor of uniform uint32 values."""
    hi, lo = _counters(key, n)
    o0, o1 = threefry2x32(key[..., None, :], hi, lo)
    return o0 ^ o1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """(..., n) float32 uniforms in [minval, maxval): one ``(n,)`` draw per
    key. As ``jax.random.uniform``: ``max(minval, u * (maxval - minval) +
    minval)`` in float32, in that order."""
    bits = random_bits(key, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return u   # the affine map is the identity: skip its launches
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) float32 standard Gumbel noise, ``jax.random.gumbel``'s
    default ("low") mode: ``-log(-log(uniform(minval=tiny, maxval=1)))``.
    The uniform bits are identical; ``log`` may round differently by an
    ulp between XLA:CPU and PyTorch."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, n, minval=tiny, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """(...) int64 samples from ``softmax(logits)`` along the last axis:
    ``argmax(logits + gumbel)``, the first index winning ties
    (``jax.random.categorical`` with its defaults). ``key`` is (..., 2)
    and ``logits`` (..., V) float32."""
    return torch.argmax(logits + gumbel(key, logits.shape[-1]), dim=-1)
