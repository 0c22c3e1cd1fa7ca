"""Keyed counter-based randomness: threefry2x32 in integer torch ops.

Port of what ``jax.random`` computes for the reference (JAX's default
``threefry2x32`` implementation with ``jax_threefry_partitionable=True``, the
default since JAX 0.5): one seed gives the same keys, bits and uniforms as
the reference's, bit for bit, on every device, so ``render_frame(seed)``
renders the reference's frame. There is no global state: every draw is a
pure function of its key.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words; leading
dimensions are a batch of keys (what the reference gets by ``vmap``). uint32
arithmetic runs in int64 masked to 32 bits (torch's ``>>`` on int32 is
arithmetic). In partitionable mode every derived value is one block cipher
call on a 64-bit counter ``(hi, lo)``:

- ``fold_in(key, d)`` and ``split(key, n)[d]`` are both
  ``threefry(key, (0, d))``, the two output words being the new key;
- ``random_bits(key, shape)`` is ``out0 ^ out1`` of ``threefry(key, (0, i))``
  over the flat index ``i`` of ``shape``.

``normal`` goes through ``erfinv``, which XLA and ATen evaluate differently
(as ATen does on the CPU and on the card), so it is not bitwise JAX's: it
agrees within 4e-7 for |z| < 2 and within 1e-5 relative in the tails, where
XLA's f32 polynomial is itself up to 2e-5 off the exact value
(``tests/test_torch_rng.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: the largest f32 below 1 in magnitude, negated: normal()'s open lower end
_MINUS_ONE_OPEN = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(math.sqrt(2.0)))


@functools.lru_cache(maxsize=None)
def scalar(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-dim tensor of ``value`` on ``device``, made once per (value,
    dtype, device) and shared: never write to it. Making a tensor from a
    Python number copies it from the host, which a stream refuses while a
    CUDA graph captures it; a tensor made once outside the capture is read
    like any other input (``Simulator.make_chained_batch``)."""
    with torch.inference_mode(False):  # usable by autograd wherever the first call ran
        return torch.tensor(value, dtype=dtype, device=device)


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of counter ``(x0, x1)``
    under key ``(k0, k1)``: int64 tensors (or ints) of uint32 values,
    broadcast against each other. Returns the two output words.

    ``x0`` is carried unmasked between rounds (its low 32 bits are right
    whatever lies above them, and it stays far below 2**63); ``x1`` is masked
    where it is rotated."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            y = x1 << r                     # rotl(x1, r) = low 32 bits of y | y >> 32
            x1 = (y ^ (y >> 32) ^ x0) & _MASK32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0 & _MASK32, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a Python int: the key (0, seed mod
    2**32) (without 64-bit mode JAX narrows the seed to 32 bits first)."""
    return torch.tensor([0, int(seed) & _MASK32], dtype=torch.int64, device=device)


def _counters(n: int, device) -> torch.Tensor:
    if n >= 2**32:
        raise NotImplementedError("more than 2**32 counters per key")
    return torch.arange(n, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` is an int or an integer tensor that
    broadcasts against the key batch ``key.shape[:-1]``."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _MASK32
    else:
        data = int(data) & _MASK32
    return torch.stack(threefry2x32(key[..., 0], key[..., 1], 0, data), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., num, 2)."""
    return fold_in(key[..., None, :], _counters(num, key.device))


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per element as int64 in [0, 2**32): (..., *shape)."""
    shape = tuple(shape)
    n = math.prod(shape)
    k0, k1 = key[..., 0], key[..., 1]
    if shape:
        k0, k1 = k0[..., None], k1[..., None]
    o0, o1 = threefry2x32(k0, k1, 0, _counters(n, key.device) if shape else 0)
    return (o0 ^ o1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform`` on [0, 1) in f32: 23 random mantissa bits
    under the exponent of 1.0, minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def normal_from_uniform(floats: torch.Tensor) -> torch.Tensor:
    """The standard normal ``jax.random.normal`` makes of a key whose
    ``uniform`` is ``floats``: sqrt(2) erfinv(u), with u the same bits
    scaled to (-1, 1) as JAX scales them, ``max(lo, floats * (1 - lo) + lo)``
    in f32 with lo the f32 next above -1 (the scale rounds to exactly 2, so
    XLA's fused multiply-add and torch's two roundings agree bitwise)."""
    lo = scalar(_MINUS_ONE_OPEN, torch.float32, floats.device)
    u = torch.maximum(lo, floats * (1.0 - lo) + lo)
    return _SQRT2 * torch.erfinv(u)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in f32."""
    return normal_from_uniform(uniform(key, shape))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds, as int64: two 32-bit draws
    combined in uint32 arithmetic that wraps as JAX's does (so for spans
    above 2**16 the multiplier 2**32 mod span wraps to 0 and only the second
    draw counts)."""
    if not -2**31 <= minval <= 2**31 - 1 or not -2**31 <= maxval <= 2**31 - 1:
        raise NotImplementedError("randint bounds outside int32")
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK32) % span
    offset = (((higher % span) * multiplier & _MASK32) + lower % span) & _MASK32
    return minval + offset % span
