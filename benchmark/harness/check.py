"""The output check: the program's sampled B-modes against the reference's.

The number compared is ``rel_l2_max``, the widest per-frame gap, as the
L2 norm of (program - reference) over the reference's L2 norm, over every
frame of the sample. Beside it ``bad_frames`` counts the frames of the
whole window that the guard on the device refused (a non-finite or a
negative pixel, or a lit pixel outside the fan); its limit is 0.
``frames_compared`` has to reach the sample's size.
"""

from __future__ import annotations

import torch


def rel_l2(program: torch.Tensor, reference: torch.Tensor) -> list[float]:
    """Per frame ||program - reference|| / ||reference|| (f64 sums); 0 for
    two zero frames, inf for a non-zero frame against a zero one."""
    p = program.to(reference.device, torch.float64).flatten(1)
    r = reference.to(torch.float64).flatten(1)
    out = []
    for gap, norm in zip(torch.linalg.vector_norm(p - r, dim=1).tolist(),
                         torch.linalg.vector_norm(r, dim=1).tolist()):
        out.append(gap / norm if norm > 0 else (0.0 if gap == 0 else float("inf")))
    return out


def verdict(gaps: list[float], bad_frames: int, limits: dict, frames_expected: int) -> dict:
    """The compared numbers, each with its limit, and whether all hold."""
    numbers = {
        "rel_l2_max": {"value": max(gaps) if gaps else float("inf"),
                       "limit": limits["rel_l2_max"]},
        "bad_frames": {"value": bad_frames, "limit": 0},
        "frames_compared": {"value": len(gaps), "limit": frames_expected},
    }
    ok = (numbers["rel_l2_max"]["value"] <= numbers["rel_l2_max"]["limit"]
          and bad_frames == 0 and len(gaps) >= frames_expected)
    return {"correct": bool(ok), "numbers": numbers}


def lines(numbers: dict) -> list[str]:
    """One line a number: its name, its value and its limit."""
    rel = {"rel_l2_max": "at most", "bad_frames": "at most", "frames_compared": "at least"}
    return [f"check {k}: {v['value']!r} ({rel[k]} {v['limit']!r})" for k, v in numbers.items()]
