"""threefry2x32 random numbers, bit-equal to ``jax.random``'s default.

The port's own copy of what the JAX package's down-sampling draws with:
``PRNGKey``, ``fold_in`` and ``uniform`` of ``jax.random`` under its default
implementation (``threefry2x32``, with ``jax_threefry_partitionable`` on, the
default of JAX 0.9). The arithmetic is numpy ``uint32`` on the host: the
draws are a host-side step of dataset preparation, and torch has no
``uint32`` arithmetic on every device.

A key is a ``(2,)`` ``uint32`` array. ``uniform`` takes its float dtype
explicitly: JAX draws in its default float dtype (float64 when
``jax_enable_x64`` is on, float32 otherwise), and the bits-to-float
conversion differs by width.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) of the count pairs
    ``(x0, x1)`` under ``key``; returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 - jax.random's name
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^63): the high and
    the low 32 bits."""
    seed = int(seed)
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the cipher of the pair
    (0, data mod 2^32)."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def random_bits(key: np.ndarray, bit_width: int, shape) -> np.ndarray:
    """32 or 64 random bits per element of ``shape``: the cipher of the
    element's flat index (high word, low word); 32 bits are the two output
    words' xor, 64 bits their concatenation."""
    n = int(np.prod(shape, dtype=np.int64))
    count = np.arange(n, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    if bit_width == 32:
        bits = b0 ^ b1
    elif bit_width == 64:
        bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    else:
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    return bits.reshape(shape)


def uniform(key: np.ndarray, shape, dtype) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1): the draw's top
    mantissa bits under the exponent of 1.0, minus 1."""
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        nbits, nmant, utype = 32, 23, np.uint32
    elif dtype == np.float64:
        nbits, nmant, utype = 64, 52, np.uint64
    else:
        raise TypeError(f"uniform draws float32 or float64, got {dtype}")
    bits = random_bits(key, nbits, tuple(shape))
    one = np.array(1.0, dtype).view(utype)
    floats = ((bits >> utype(nbits - nmant)) | one).view(dtype) - dtype.type(1.0)
    return np.maximum(floats, dtype.type(0.0))
