"""Threefry-2x32 counter-based random numbers in NumPy uint32 arithmetic.

The benchmark's own copy of the generator the searched program uses, written
from the published algorithm (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011; the key schedule and rotations of Random123's
threefry2x32-20) and the conventions below, not from the program's code:

- a key is a ``(..., 2)`` uint32 array;
- ``fold_in(k, d)``  = ``threefry(k, (0, d))``: a new key;
- ``split(k, n)``    = ``threefry(k, (0, j))`` for ``j < n``, stacked;
- ``uniform(k, n)``  = for ``j < n`` the bits ``o0 ^ o1`` of
  ``threefry(k, (0, j))`` as the float32 ``bitcast((bits >> 9) |
  0x3F800000) - 1`` in [0, 1).

Every function is batched over leading axes. Additions wrap modulo 2**32,
which NumPy's uint32 arrays do silently.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_PARITY = _U32(0x1BD11BDA)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
MASK = 0xFFFFFFFF


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The two uint32 output words of threefry2x32-20 of the counter
    ``(x0, x1)`` under ``key`` (``(..., 2)``), broadcast together."""
    k0 = key[..., 0].astype(_U32)
    k1 = key[..., 1].astype(_U32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):   # 0-d operands warn on the wrap
        x0 = np.asarray(x0, dtype=_U32) + ks[0]
        x1 = np.asarray(x1, dtype=_U32) + ks[1]
        for g in range(5):
            for r in _ROTATIONS[g % 2]:
                x0 = x0 + x1
                x1 = ((x1 << _U32(r)) | (x1 >> _U32(32 - r))) ^ x0
            x0 = x0 + ks[(g + 1) % 3]
            x1 = x1 + ks[(g + 2) % 3] + _U32(g + 1)
    return x0, x1


def key_from_seed(seed: int) -> np.ndarray:
    """A (2,) key from a non-negative integer of up to 64 bits: its high
    and low 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} outside [0, 2**64)")
    return np.array([(seed >> 32) & MASK, seed & MASK], dtype=_U32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``key`` (..., 2) with integer ``data`` (...) folded in, broadcast."""
    d = np.asarray(data).astype(np.int64) & MASK
    o0, o1 = threefry2x32(key, np.zeros_like(d, dtype=_U32), d.astype(_U32))
    return np.stack([o0, o1], axis=-1)


def split(key: np.ndarray, n: int) -> np.ndarray:
    """(..., 2) -> (..., n, 2): ``n`` keys from each key."""
    j = np.arange(n, dtype=_U32)
    o0, o1 = threefry2x32(key[..., None, :], np.zeros_like(j), j)
    return np.stack([o0, o1], axis=-1)


def uniform(key: np.ndarray, n: int) -> np.ndarray:
    """(..., 2) -> (..., n) float32 uniforms in [0, 1)."""
    j = np.arange(n, dtype=_U32)
    o0, o1 = threefry2x32(key[..., None, :], np.zeros_like(j), j)
    bits = ((o0 ^ o1) >> _U32(9)) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
