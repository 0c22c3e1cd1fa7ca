"""Scatterer texture: the hashed per-voxel N(0,1) field and its lookup.

Port of ``mcray_tpu/ops/texture.py:31-191``, both texture modes: the
procedural field, and the "table" mode, whose (size^3) tables are filled
from that same field and gathered from. The field is a pure function of
the integer voxel index and two seeds, so the port reproduces the
reference's bits exactly: the lowbias32 hash runs in int64 with an exact
32-bit multiply (torch's ``>>`` on int32 is arithmetic and would smear the
sign bit), and the popcount of the high 16 bits is a SWAR bit count (torch
has no popcount op). The CUDA march kernel (``csrc/march.cu``) evaluates
the same hash with ``uint32_t`` arithmetic and ``__popc``.

Lookup replicates the reference's C++ semantics in hard mode: nearest voxel
by float->int truncation and a wrap of the index into [0, size)
(src/volume.h:52-54), then the Burger13 Eq. 15 threshold
``prob >= density ? noise*sigma + mu : 0`` (src/volume.h:58-60).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import SimConfig
from ..utils.rng import randint, scalar, split

_MASK32 = 0xFFFFFFFF

# dithered-binomial normaliser 1/sqrt(Var[Binomial(16, 1/2)] + Var[U(0,1)]),
# rounded to f32 exactly as the reference rounds it
BITSUM_SCALE = float(np.float32(1.0 / (4.0 + 1.0 / 12.0) ** 0.5))


def fdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE f32 division. PyTorch on CUDA turns a division
    by a Python scalar into a multiply by its reciprocal, which can move a
    quotient by one ulp; dividing by a 0-dim tensor on ``x``'s device keeps
    the true quotient that the reference and the CUDA kernels compute. The
    divisor is made once per (d, dtype, device) (``rng.scalar``), so a CUDA
    graph can capture the division."""
    return x / scalar(d, x.dtype, x.device)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for 0 <= x < 2**32, in int64 without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche hash on uint32 values held in int64."""
    x = x.long() & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def _bitsum_normal(bits: torch.Tensor) -> torch.Tensor:
    """~N(0,1) from one 32-bit hash word: popcount of the high 16 bits plus
    a (0, 1) dither from the low 16 bits (cfg.scatter_rng == "bitsum")."""
    pc = _popcount16(bits >> 16).float()
    u = ((bits & 0xFFFF).float() + 0.5) * (1.0 / 65536.0)
    return (pc + u - 8.5) * BITSUM_SCALE


def procedural_fields(ix, iy, iz, seeds, size: int, rng: str = "boxmuller"):
    """(noise, prob) ~ iid N(0,1) per (wrapped) voxel from an integer hash;
    ``seeds`` is a (2,) integer tensor of uint32 values."""
    vid = ((ix.long() * size + iy.long()) * size + iz.long()) & _MASK32
    b1 = hash_u32(vid ^ seeds[0])
    b2 = hash_u32(vid ^ seeds[1])
    if rng == "bitsum":
        return _bitsum_normal(b1), _bitsum_normal(b2)
    # (bits + 0.5) / 2^24 in (0, 1): log is always finite
    u1 = ((b1 >> 8).float() + 0.5) * (1.0 / 16777216.0)
    u2 = ((b2 >> 8).float() + 0.5) * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _wrap_mod(q: torch.Tensor, size: int) -> torch.Tensor:
    """((q % size) + size) % size; a single AND for power-of-two sizes."""
    if size & (size - 1) == 0:
        return q & (size - 1)
    return torch.remainder(torch.remainder(q, size) + size, size)


def _wrap_index(x: torch.Tensor, res_mm: float, size: int) -> torch.Tensor:
    """static_cast<unsigned>(x/res) % size for possibly-negative x."""
    return _wrap_mod(torch.trunc(fdiv(x, res_mm)).long(), size)


def make_texture_volume(key: torch.Tensor, cfg: SimConfig, device=None) -> dict[str, torch.Tensor]:
    """Scatterer field state: the two seeds the reference draws from ``key``
    (``split``, then ``randint(0, 2**31 - 1)`` of the first half), on the
    key's device. In "table" mode also the materialised ``noise`` and
    ``prob`` tables (size^3 each, on ``device``, by default the key's),
    filled from the same hash field, so a table gather equals the
    procedural field bit for bit and the march kernels, which evaluate the
    hash, serve both modes (``mcray_tpu/ops/texture.py:31-66``)."""
    seeds = randint(split(key)[0], (2,), 0, 2**31 - 1)
    if cfg.texture_mode == "procedural":
        return {"seeds": seeds}
    noise, prob = texture_tables(seeds, cfg, seeds.device if device is None else device)
    return {"noise": noise, "prob": prob, "seeds": seeds}


def texture_tables(seeds: torch.Tensor, cfg: SimConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (size, size, size) noise and prob tables of the field of
    ``seeds``, indexed [ix, iy, iz], filled one ix slab at a time."""
    s = cfg.volume_size
    axis = torch.arange(s, dtype=torch.int64, device=device)
    iy, iz = torch.meshgrid(axis, axis, indexing="ij")
    seeds = seeds.to(device)
    noise = torch.empty((s, s, s), dtype=torch.float32, device=device)
    prob = torch.empty_like(noise)
    for ix in range(s):
        noise[ix], prob[ix] = procedural_fields(torch.full_like(iy, ix), iy, iz, seeds, s,
                                                rng=cfg.scatter_rng)
    return noise, prob


def get_scattering(volume, density, mu, sigma, points, cfg: SimConfig) -> torch.Tensor:
    """Scattering amplitude at world ``points`` (..., 3); ``density`` is the
    material's mu1, ``mu`` its mu0 (reference src/main.cpp:126). A volume
    with tables is gathered from, else the field is evaluated."""
    res = cfg.resolution_um / 1000.0
    size = cfg.volume_size

    if "noise" in volume:
        def fetch(ix, iy, iz):
            return volume["noise"][ix, iy, iz], volume["prob"][ix, iy, iz]
    else:
        def fetch(ix, iy, iz):
            return procedural_fields(ix, iy, iz, volume["seeds"], size, rng=cfg.scatter_rng)

    if cfg.trilinear_texture:
        f = fdiv(points, res) - 0.5
        i0 = torch.floor(f).long()
        w = f - i0.float()
        noise = torch.zeros(points.shape[:-1], dtype=torch.float32, device=points.device)
        prob = torch.zeros_like(noise)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    idx = [_wrap_mod(i0[..., a] + o, size) for a, o in enumerate((dx, dy, dz))]
                    n, p = fetch(*idx)
                    wa = [w[..., a] if o else 1.0 - w[..., a] for a, o in enumerate((dx, dy, dz))]
                    wt = wa[0] * wa[1] * wa[2]
                    noise = noise + n * wt
                    prob = prob + p * wt
    else:
        noise, prob = fetch(*(_wrap_index(points[..., a], res, size) for a in range(3)))

    value = noise * sigma + mu
    if cfg.soft_scattering:
        return value * torch.sigmoid(fdiv(prob - density, cfg.soft_scattering_tau))
    return torch.where(prob >= density, value, 0.0)
