"""Simulation configuration: the reference's ``SimConfig``, validated.

``mcray_tpu.config`` is JAX-free, so the dataclass is re-exported as is;
the port adds ``validate``, which raises on unknown mode strings (the
reference silently falls through to a default branch on a typo).
"""

from __future__ import annotations

from mcray_tpu.config import DEFAULT_CONFIG, SimConfig, small_test_config

__all__ = ["SimConfig", "DEFAULT_CONFIG", "small_test_config", "validate"]

SCATTER_RNGS = ("bitsum", "boxmuller")
TEXTURE_MODES = ("procedural", "table")
ENVELOPE_MODES = ("reference", "hilbert")
PROBE_TYPES = ("convex", "linear", "phased")


def validate(cfg: SimConfig) -> SimConfig:
    """Return ``cfg`` unchanged, or raise ValueError naming the bad field."""
    for name, allowed in (
        ("scatter_rng", SCATTER_RNGS),
        ("texture_mode", TEXTURE_MODES),
        ("envelope_mode", ENVELOPE_MODES),
        ("probe_type", PROBE_TYPES),
    ):
        value = getattr(cfg, name)
        if value not in allowed:
            raise ValueError(f"SimConfig.{name}={value!r}; expected one of {allowed}")
    return cfg
