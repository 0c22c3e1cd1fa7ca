"""Checkpoint / resume for the differentiable-fit workload.

Port of ``mcray_tpu/utils/checkpoint.py``: the material table, Adam's state
(``exp_avg``, ``exp_avg_sq``, its step count) and the fit's step counter in
one npz file, written through a temporary file so that a fit cut short never
leaves a half-written checkpoint.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.trainer import FitState

OPT_KEYS = ("exp_avg", "exp_avg_sq")


def save_fit_state(path: str, state, extra: dict | None = None) -> None:
    """Persist a ``trainer.FitState`` (materials, Adam state, step)."""
    payload = {
        "materials": state.materials.detach().cpu().numpy(),
        "step": np.asarray(state.step),
        "opt_step": np.asarray(state.opt_state["step"]),
    }
    for key in OPT_KEYS:
        payload[f"opt_{key}"] = state.opt_state[key].detach().cpu().numpy()
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_fit_state(path: str, template_state):
    """The stored ``FitState``, checked against ``template_state`` (a state of
    the fitter it is for): an optimiser state of another kind or shape raises."""
    with np.load(path, allow_pickle=False) as data:
        stored = {k: data[k] for k in data.files}
    want = tuple(template_state.materials.shape)
    missing = [k for k in ("materials", "step", "opt_step", *(f"opt_{k}" for k in OPT_KEYS))
               if k not in stored]
    shapes = {k: stored[k].shape for k in ("materials", *(f"opt_{k}" for k in OPT_KEYS))
              if k in stored}
    if missing or any(tuple(s) != want for s in shapes.values()):
        raise ValueError(
            f"checkpoint optimiser state does not match the template (missing {missing}, "
            f"stored shapes {shapes}, template {want}) — was it saved with a different "
            "optimiser or scene?")
    device = template_state.materials.device
    opt_state = {k: torch.from_numpy(stored[f"opt_{k}"]).to(device) for k in OPT_KEYS}
    opt_state["step"] = int(stored["opt_step"])
    return FitState(materials=torch.from_numpy(stored["materials"]).to(device),
                    opt_state=opt_state, step=int(stored["step"]))
