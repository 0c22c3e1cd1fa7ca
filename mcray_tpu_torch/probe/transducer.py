"""Transducer element layout as a pure function of probe pose.

Port of ``mcray_tpu/probe/transducer.py:22-101``: positions and outward
beam directions of all N elements for the convex (the reference's arc,
src/transducer.h:41-59), linear and phased probe families, for one pose or
a batch of poses.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..ops.geometry import euler_zxy


def element_layout(position: torch.Tensor, angles_deg: torch.Tensor, cfg: SimConfig):
    """(positions (N, 3), directions (N, 3)) on ``position``'s device for
    one pose, ``position`` and ``angles_deg`` (3,); for B poses, (B, 3) each,
    (B * N, 3) each, frame-major (pose b's elements are rows [b N, (b+1) N))."""
    if cfg.probe_type == "linear":
        positions, directions = element_layout_linear(position, angles_deg, cfg)
    elif cfg.probe_type == "phased":
        positions, directions = element_layout_phased(position, angles_deg, cfg)
    else:
        positions, directions = element_layout_convex(position, angles_deg, cfg)
    return positions.reshape(-1, 3), directions.reshape(-1, 3)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=like.device)


def _unit_fan(angles: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.sin(angles), torch.cos(angles), torch.zeros_like(angles)], dim=-1)


def _rotated(v: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """``v`` (N, 3) rotated by each pose's angles (..., 3): (..., N, 3)."""
    return euler_zxy(v, torch.deg2rad(angles_deg.float())[..., None, :])


def element_layout_linear(position, angles_deg, cfg: SimConfig):
    """N elements along the rotated x axis at the reference's element pitch,
    all beams parallel to the rotated +y axis."""
    n = cfg.transducer_elements
    pitch_world = cfg.element_separation_mm / 10.0  # mm -> world (cm-ish)
    offsets = (_arange(n, position) - (n - 1) / 2.0) * pitch_world
    axes = torch.eye(3, device=position.device)[:2]  # made on the device: no host copy
    rotated = _rotated(axes, angles_deg)
    lateral, beam = rotated[..., 0, :], rotated[..., 1, :]
    positions = position.float()[..., None, :] + offsets[:, None] * lateral[..., None, :]
    return positions, beam[..., None, :].expand(positions.shape)


def element_layout_phased(position, angles_deg, cfg: SimConfig):
    """Beam k steered across the sector, all emitted from the probe position
    (the sector apex that the radius->0 scan conversion assumes)."""
    n = cfg.transducer_elements
    total = cfg.transducer_amplitude_rad
    steer = -(total / 2.0) + total * (_arange(n, position) + 0.5) / n
    directions = _rotated(_unit_fan(steer), angles_deg)
    return position.float()[..., None, :].expand(directions.shape), directions


def element_layout_convex(position, angles_deg, cfg: SimConfig):
    """Convex arc: angular pitch = separation/radius, first element at
    -(pitch*N/2) + pitch/2; position = probe_pos + radius_cm * dir."""
    n = cfg.transducer_elements
    radius_mm = cfg.transducer_radius_cm * 10.0
    pitch = cfg.element_separation_mm / radius_mm  # [rad] per element
    angle0 = -(pitch * n / 2.0) + pitch / 2.0
    angles = angle0 + pitch * _arange(n, position)
    directions = _rotated(_unit_fan(angles), angles_deg)
    return position.float()[..., None, :] + cfg.transducer_radius_cm * directions, directions
