"""Keyed randomness of the frame: threefry2x32 in integer torch ops.

A key is an int64 tensor ``(..., 2)`` of two uint32 words. In JAX's
partitionable threefry mode, which the simulator's keying follows, every
derived value is one block cipher call on a 64-bit counter ``(0, i)``:
``fold_in(key, d)`` and ``split(key, n)[d]`` are ``threefry(key, (0, d))``,
and ``random_bits(key, shape)`` is ``out0 ^ out1`` of ``threefry(key, (0,
i))`` over the flat index ``i``. uint32 arithmetic runs in int64 masked to
32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MINUS_ONE_OPEN = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of counter (x0, x1) under key (k0, k1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            y = x1 << r
            x1 = (y ^ (y >> 32) ^ x0) & MASK32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0 & MASK32, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """The key (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``data``: an int or an integer tensor broadcasting against ``key.shape[:-1]``."""
    data = data.to(torch.int64) & MASK32 if isinstance(data, torch.Tensor) else int(data) & MASK32
    return torch.stack(threefry2x32(key[..., 0], key[..., 1], 0, data), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """Keys (..., 2) -> (..., num, 2)."""
    return fold_in(key[..., None, :], torch.arange(num, dtype=torch.int64, device=key.device))


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits an element, int64 in [0, 2**32): (..., *shape)."""
    shape = tuple(shape)
    n = math.prod(shape)
    k0, k1 = key[..., 0], key[..., 1]
    if shape:
        k0, k1 = k0[..., None], k1[..., None]
    counters = torch.arange(n, dtype=torch.int64, device=key.device) if shape else 0
    o0, o1 = threefry2x32(k0, k1, 0, counters)
    return (o0 ^ o1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """f32 on [0, 1): 23 random mantissa bits under the exponent of 1.0, minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def normal_from_uniform(floats: torch.Tensor) -> torch.Tensor:
    """sqrt(2) erfinv(u), u the uniform's bits scaled to (-1, 1)."""
    lo = torch.tensor(_MINUS_ONE_OPEN, dtype=torch.float32, device=floats.device)
    u = torch.maximum(lo, floats * (1.0 - lo) + lo)
    return _SQRT2 * torch.erfinv(u)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """Integers in [minval, maxval) from two 32-bit draws combined in
    wrapping uint32 arithmetic."""
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (((higher % span) * multiplier & MASK32) + lower % span) & MASK32
    return minval + offset % span
