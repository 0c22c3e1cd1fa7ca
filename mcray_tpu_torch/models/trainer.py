"""Differentiable fit: recover acoustic material parameters from a target
B-mode image by gradient descent through the whole renderer.

Port of ``mcray_tpu/models/trainer.py:33-141`` and ``_run_loop``
(``:352-370``). The loss is pixel MSE on the scan-converted B-mode and
gradients flow through scan conversion (K9), envelope and convolution, the
march (K8), Beer-Lambert attenuation, Fresnel splits and the
perturbed-normal sampling into the (M, 8) material table. For useful
gradients on the scattering threshold (mu1) enable ``cfg.soft_scattering``
and ``cfg.trilinear_texture``.

The update is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the
update of ``optax.adam`` at its defaults. ``PoseFitter`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops import physics
from ..utils import rng

# Default trainable columns: impedance, attenuation, mu0, mu1, sigma.
# Specularity/shininess/thickness stay frozen (integer-ish semantics).
DEFAULT_TRAINABLE = (
    physics.IMPEDANCE,
    physics.ATTENUATION,
    physics.MU0,
    physics.MU1,
    physics.SIGMA,
)


def column_mask(n_materials: int, columns=DEFAULT_TRAINABLE, rows=None) -> torch.Tensor:
    """(M, 8) trainability mask. Restricting ``rows`` to the materials under
    fit matters with Adam: its per-parameter normalisation moves every masked
    parameter by ~lr regardless of gradient magnitude, so leaving a
    near-zero-gradient material (the reference scenes' GEL, attenuation 1e-8)
    trainable lets the optimiser wander it destructively."""
    mask = torch.zeros((n_materials, 8), dtype=torch.float32)
    for r in range(n_materials) if rows is None else rows:
        mask[r, list(columns)] = 1.0
    return mask


@dataclasses.dataclass
class FitState:
    materials: torch.Tensor
    opt_state: dict          # Adam's {"exp_avg", "exp_avg_sq", "step"}
    step: int = 0


class MaterialFitter:
    """Adam fit of the material table against a target B-mode.

    ``render_fn(frame, materials) -> bmode`` renders one frame,
    differentiable in ``materials``; ``frame`` says which randomness: an int
    frame seed, a (2,) key of ``utils/rng.py`` (what ``run`` hands out, as
    the reference's fit loop does), or whatever ``fixed_frame`` holds (a
    seed, a key, or a dict of draws). The tensors live where
    ``init_materials`` lives (hand in the simulator's), so a fitter built
    from a ``Simulator`` on the card fits on the card.

    ``fixed_frame`` freezes the Monte-Carlo noise (the same speckle
    realisation for target and prediction), the standard inverse-rendering
    set-up; without it the fit sees a speckle-decorrelation noise floor and
    needs ``n_frames_per_step`` > 1 to average it out.
    """

    def __init__(
        self,
        render_fn: Callable[..., torch.Tensor],
        init_materials: torch.Tensor,
        target: torch.Tensor,
        learning_rate: float = 1e-2,
        trainable=DEFAULT_TRAINABLE,
        trainable_rows=None,
        n_frames_per_step: int = 1,
        fixed_frame=None,
    ):
        self.render_fn = render_fn
        self.device = init_materials.device
        self.target = target.detach().to(self.device)
        self.mask = column_mask(init_materials.shape[0], trainable, trainable_rows).to(self.device)
        self.n_frames = n_frames_per_step
        self.fixed_frame = fixed_frame
        self._params = init_materials.detach().clone().to(torch.float32).requires_grad_(True)
        self.optimizer = torch.optim.Adam([self._params], lr=learning_rate, betas=(0.9, 0.999),
                                          eps=1e-8)
        self.step_count = 0
        self.last_grad = None

    @classmethod
    def from_simulator(cls, sim, init_materials, target, *, position=None, angles=None, **kw):
        """A fitter rendering through ``sim.render_frame`` on ``sim``'s device;
        ``init_materials`` and ``target`` may be arrays or tensors."""
        def render_fn(frame, materials):
            draws = frame if isinstance(frame, dict) else None
            return sim.render_frame(0 if draws is not None else frame, materials, position,
                                    angles, draws=draws)["bmode"]

        init = torch.as_tensor(init_materials, dtype=torch.float32, device=sim.device)
        return cls(render_fn, init, torch.as_tensor(target, device=sim.device), **kw)

    # --- state, as the checkpoint stores it -------------------------------
    @property
    def state(self) -> FitState:
        adam = self.optimizer.state.get(self._params, {})
        zeros = torch.zeros_like(self._params)
        opt_state = {
            "exp_avg": adam.get("exp_avg", zeros).detach().clone(),
            "exp_avg_sq": adam.get("exp_avg_sq", zeros).detach().clone(),
            "step": int(adam["step"]) if "step" in adam else 0,
        }
        return FitState(self._params.detach().clone(), opt_state, self.step_count)

    @state.setter
    def state(self, value: FitState) -> None:
        opt = value.opt_state
        shape = self._params.shape
        if (set(opt) != {"exp_avg", "exp_avg_sq", "step"}
                or tuple(opt["exp_avg"].shape) != tuple(shape)
                or tuple(opt["exp_avg_sq"].shape) != tuple(shape)
                or tuple(value.materials.shape) != tuple(shape)):
            raise ValueError("fit state does not match this fitter's Adam state "
                             f"(materials and moments of shape {tuple(shape)})")
        with torch.no_grad():
            self._params.copy_(value.materials.to(self.device))
        self.optimizer.state[self._params] = {
            # Adam keeps its step count as a float32 tensor on the CPU
            "step": torch.tensor(float(opt["step"]), dtype=torch.float32),
            "exp_avg": opt["exp_avg"].to(self.device, torch.float32).clone(),
            "exp_avg_sq": opt["exp_avg_sq"].to(self.device, torch.float32).clone(),
        }
        self.step_count = int(value.step)

    # --- one step ---------------------------------------------------------
    def loss(self, materials: torch.Tensor, frame) -> torch.Tensor:
        """Pixel MSE of the frame (the mean of ``n_frames_per_step`` frames,
        keyed by ``split(key of frame, n_frames_per_step)`` as the reference
        keys them) against the target."""
        if self.n_frames == 1:
            pred = self.render_fn(frame, materials)
        else:
            if isinstance(frame, dict):
                raise ValueError("n_frames_per_step > 1 needs an integer frame seed or a key, "
                                 "not fixed draws")
            key = frame if isinstance(frame, torch.Tensor) else rng.prng_key(frame)
            pred = torch.stack([self.render_fn(k, materials)
                                for k in rng.split(key, self.n_frames)]).mean(dim=0)
        return torch.mean((pred - self.target) ** 2)

    def step(self, frame) -> float:
        """One Adam step on the masked gradient; returns the loss before it."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(self._params, frame)
        loss.backward()
        self._params.grad.mul_(self.mask)
        self.last_grad = self._params.grad.detach().clone()
        self.optimizer.step()
        with torch.no_grad():
            # keep physical parameters positive, on trainable entries only
            clamped = torch.clamp(self._params, min=1e-4)
            self._params.copy_(torch.where(self.mask > 0, clamped, self._params))
        self.step_count += 1
        return float(loss.detach())

    def run(self, n_steps: int, seed: int = 0, log_every: int = 10, verbose: bool = True):
        """``n_steps`` steps; each renders with ``fixed_frame``, or else with
        the key ``fold_in(prng_key(seed), step)`` (a fresh realisation per
        step, keyed as the reference's fit loop keys it). Returns the losses."""
        losses = []
        for i in range(n_steps):
            frame = (self.fixed_frame if self.fixed_frame is not None
                     else rng.fold_in(rng.prng_key(seed), self.step_count))
            losses.append(self.step(frame))
            if verbose and (i % log_every == 0 or i == n_steps - 1):
                gnorm = float(torch.linalg.norm(self.last_grad))
                print(f"step {self.step_count}: loss {losses[-1]:.6g} |g| {gnorm:.3g}")
        return losses
