"""Differentiable fit: recover acoustic material parameters, or the probe
pose, from a target B-mode image through the whole renderer.

Port of ``mcray_tpu/models/trainer.py``: ``MaterialFitter`` (``:33-141``),
``PoseFitter`` (``:144-349``) and ``_run_loop`` (``:352-370``). The
material loss is pixel MSE on the scan-converted B-mode and gradients flow
through scan conversion (K9), envelope and convolution, the march (K8),
Beer-Lambert attenuation, Fresnel splits and the perturbed-normal sampling
into the (M, 8) material table. For useful
gradients on the scattering threshold (mu1) enable ``cfg.soft_scattering``
and ``cfg.trilinear_texture``.

The update is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the
update of ``optax.adam`` at its defaults; on the card the material fit's
is ``capturable``, so that the update a CUDA graph replays is the one an
eager step makes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops import physics
from ..ops.cuda.draws import fold_in
from ..ops.imaging import gaussian_blur
from ..utils import profiling, rng
from .graph_step import GraphStep

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


def _adam(params, learning_rate: float, capturable: bool = False) -> torch.optim.Adam:
    """``optax.adam``'s update at its defaults (``capturable``: its state and
    arithmetic on the parameters' card, for a CUDA graph)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def _adam_state(optimizer: torch.optim.Adam, param: torch.Tensor) -> dict:
    adam = optimizer.state.get(param, {})
    zeros = torch.zeros_like(param)
    return {"exp_avg": adam.get("exp_avg", zeros).detach().clone(),
            "exp_avg_sq": adam.get("exp_avg_sq", zeros).detach().clone(),
            "step": int(adam["step"]) if "step" in adam else 0}


class MaterialFitter:
    """Adam fit of the material table against a target B-mode.

    ``render_fn(frame, materials) -> bmode`` renders one frame,
    differentiable in ``materials``; ``frame`` says which randomness: an int
    frame seed, a (2,) key of ``utils/rng.py`` (what ``run`` hands out, as
    the reference's fit loop does, on the fitter's device), or the fixed
    draws of ``fixed_frame`` (a dict). The tensors live where
    ``init_materials`` lives (hand in the simulator's), so a fitter built
    from a ``Simulator`` on the card fits on the card.

    ``fixed_frame`` freezes the Monte-Carlo noise (the same speckle
    realisation for target and prediction), the standard inverse-rendering
    set-up; without it the fit sees a speckle-decorrelation noise floor and
    needs ``n_frames_per_step`` > 1 to average it out. Those frames render
    in one batched call through ``render_batch_fn(keys (n, 2), materials)
    -> (n, H, W)`` where one is given (``from_simulator`` gives
    ``Simulator.render_batch``), as the reference's ``vmap`` does; with the
    bare ``render_fn`` alone they render one after another.

    ``run`` steps from buffers on the fitter's device: the key of step i is
    ``fold_in(prng_key(seed), i)`` from a key buffer and a step counter that
    the step advances (a fixed seed or key: that key), then the frames, the
    loss, the backward, the mask, Adam and the clamp. On the card that step
    is replayed from a CUDA graph (``graph_step.GraphStep``, named ``fit``),
    captured at the first call after an eager warm-up step that also builds
    Adam's state (the fit's state is put back after it): no host value enters
    between steps, and a call reads its losses from the card once. A call's
    ``seed``, and a new start set through ``state``, are copied into the
    graph's buffers; nothing is captured again. ``last_grad`` (the masked
    gradient) and ``last_frames`` are then the graph's buffers, which the next
    step overwrites. The graph reads the target and the renderer's tensors as
    they are at capture. ``step(frame)`` is one step of the same arithmetic,
    eager, on any device. The kernels' launch counters count a replay's
    launches (``launches``, by kernel) as the chained batch's do.

    Tracing: a call is the span ``fit.call`` (a request id of its own;
    ``units``: its frames), each replay a child span ``fit.replay``, the
    warm-up and capture the span ``fit.capture``; the counters
    ``fit.graph_nodes`` and ``fit.graph_frames`` count the step graph's nodes
    and frames once, at capture. A step marks the six stages of its forward
    (``draws`` first), then ``image_bwd`` where the loss starts, and through
    the backward ``march_bwd`` and ``trace_bwd``, then ``update``
    (``utils/profiling.py``).
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
        render_batch_fn: Callable[..., torch.Tensor] | None = None,
    ):
        self.render_fn = render_fn
        self.render_batch_fn = render_batch_fn
        self.device = init_materials.device
        self.target = target.detach().to(self.device)
        self.mask = column_mask(init_materials.shape[0], trainable, trainable_rows).to(self.device)
        self.n_frames = n_frames_per_step
        self._params = init_materials.detach().clone().to(torch.float32).requires_grad_(True)
        self.optimizer = _adam([self._params], learning_rate,
                               capturable=self.device.type == "cuda")
        self.step_count = 0
        self.last_grad = None
        self.last_frames = None
        # the buffers a step reads: the seed's key, the step counter, the frame offsets
        self._key = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._step = torch.zeros((), dtype=torch.int64, device=self.device)
        self._offsets = torch.arange(n_frames_per_step, dtype=torch.int64, device=self.device)
        self._fixed = fixed_frame
        if fixed_frame is not None and not isinstance(fixed_frame, dict):
            key = fixed_frame if isinstance(fixed_frame, torch.Tensor) else rng.prng_key(fixed_frame)
            self._fixed = key.to(self.device)
        self._graph = GraphStep(self._step_on_buffers, self.device, "fit", n_frames_per_step,
                                around_warmup=self._state_kept)

    @property
    def graph(self):
        """The step's CUDA graph once captured; None before, and on the CPU."""
        return self._graph.graph

    @property
    def launches(self) -> dict[str, int]:
        """The captured step's kernel launches, by kernel (``launch_counts``'
        names); ``{}`` before the capture, and on the CPU."""
        return self._graph.launches

    @classmethod
    def from_simulator(cls, sim, init_materials, target, *, position=None, angles=None, **kw):
        """A fitter rendering through ``sim.render_frame`` (several frames a
        step: ``sim.render_batch``, one batched call) on ``sim``'s device;
        ``init_materials`` and ``target`` may be arrays or tensors."""
        def render_fn(frame, materials):
            draws = frame if isinstance(frame, dict) else None
            return sim.render_frame(0 if draws is not None else frame, materials, position,
                                    angles, draws=draws)["bmode"]

        def render_batch_fn(keys, materials):
            return sim.render_batch(keys, materials, position, angles)

        init = torch.as_tensor(init_materials, dtype=torch.float32, device=sim.device)
        return cls(render_fn, init, torch.as_tensor(target, device=sim.device),
                   render_batch_fn=render_batch_fn, **kw)

    # --- state, as the checkpoint stores it -------------------------------
    @property
    def state(self) -> FitState:
        return FitState(self._params.detach().clone(), _adam_state(self.optimizer, self._params),
                        self.step_count)

    @state.setter
    def state(self, value: FitState) -> None:
        """Copies ``value`` into the fitter's tensors (Adam's too, where it
        has them), so a captured step reads it."""
        opt = value.opt_state
        shape = self._params.shape
        if (set(opt) != {"exp_avg", "exp_avg_sq", "step"}
                or tuple(opt["exp_avg"].shape) != tuple(shape)
                or tuple(opt["exp_avg_sq"].shape) != tuple(shape)
                or tuple(value.materials.shape) != tuple(shape)):
            raise ValueError("fit state does not match this fitter's Adam state "
                             f"(materials and moments of shape {tuple(shape)})")
        # Adam keeps its step count as a float32 tensor, on the card where it is capturable
        capturable = self.optimizer.defaults["capturable"]
        step = torch.tensor(float(opt["step"]), dtype=torch.float32,
                            device=self.device if capturable else "cpu")
        adam = self.optimizer.state[self._params]
        with torch.no_grad():
            self._params.copy_(value.materials.to(self.device))
            for key, v in (("step", step), ("exp_avg", opt["exp_avg"]),
                           ("exp_avg_sq", opt["exp_avg_sq"])):
                if key in adam:
                    adam[key].copy_(v)
                else:
                    adam[key] = v if key == "step" else v.to(self.device, torch.float32).clone()
        self.step_count = int(value.step)

    # --- one step ---------------------------------------------------------
    def _frames(self, materials: torch.Tensor, frame) -> torch.Tensor:
        """The (n_frames_per_step, H, W) B-modes of ``frame``: the frames of
        the keys ``split(key of frame, n_frames_per_step)`` as the reference
        keys them (one batched call where ``render_batch_fn`` is given), or
        for one frame a step ``render_fn(frame)``."""
        if self.n_frames == 1:
            return self.render_fn(frame, materials)[None]
        if isinstance(frame, dict):
            raise ValueError("n_frames_per_step > 1 needs an integer frame seed or a key, "
                             "not fixed draws")
        key = frame if isinstance(frame, torch.Tensor) else rng.prng_key(frame)
        keys = fold_in(key, self._offsets.to(key.device))
        if self.render_batch_fn is not None:
            return self.render_batch_fn(keys, materials)
        return torch.stack([self.render_fn(k, materials) for k in keys])

    def _loss(self, frames: torch.Tensor) -> torch.Tensor:
        profiling.mark("image_bwd", frames.device)
        pred = frames[0] if frames.shape[0] == 1 else frames.mean(dim=0)
        return torch.mean((pred - self.target) ** 2)

    def loss(self, materials: torch.Tensor, frame) -> torch.Tensor:
        """Pixel MSE of the frame (the mean of ``n_frames_per_step`` frames,
        ``_frames``) against the target."""
        return self._loss(self._frames(materials, frame))

    def _update(self, frame) -> dict[str, torch.Tensor]:
        """One Adam step on the masked gradient of ``frame``'s loss, then the
        clamp; returns the step's ``loss`` (before it), ``grad`` (masked),
        ``frames`` and ``record`` (the loss and the gradient's norm)."""
        self.optimizer.zero_grad(set_to_none=True)
        frames = self._frames(self._params, frame)
        loss = self._loss(frames)
        loss.backward()
        profiling.mark("update", self.device)
        grad = self._params.grad.mul_(self.mask)
        self.optimizer.step()
        with torch.no_grad():
            # keep physical parameters positive, on trainable entries only
            clamped = torch.clamp(self._params, min=1e-4)
            self._params.copy_(torch.where(self.mask > 0, clamped, self._params))
        loss = loss.detach()
        return {"loss": loss, "grad": grad, "frames": frames.detach(),
                "record": torch.stack([loss, torch.linalg.vector_norm(grad)])}

    def step(self, frame) -> float:
        """One eager Adam step on the masked gradient; returns the loss before it."""
        out = self._update(frame)
        self.last_grad = out["grad"].detach().clone()
        self.last_frames = out["frames"]
        self.step_count += 1
        return float(out["loss"])

    def _step_on_buffers(self) -> dict[str, torch.Tensor]:
        """``run``'s step: the frame (the fixed one, or the key of the step
        counter), the update, the counter advanced."""
        profiling.mark("draws", self.device)
        frame = self._fixed if self._fixed is not None else fold_in(self._key, self._step)
        out = self._update(frame)
        self._step.add_(1)
        return out

    @contextlib.contextmanager
    def _state_kept(self):
        """Puts the fit's state back after the warm-up step of the capture."""
        start = self.state
        yield
        self.state = start

    def _steps(self, n_steps: int, seed: int = 0) -> torch.Tensor:
        """``n_steps`` steps from the buffers (``run``), unread: the (n_steps,
        2) losses and gradient norms on the fitter's device."""
        with profiling.span("fit.call", request=profiling.request(),
                            units=n_steps * self.n_frames):
            self._graph.capture()
            self._key.copy_(rng.prng_key(seed))
            self._step.fill_(self.step_count)
            records = []
            out = self._graph.run(n_steps, lambda o: records.append(o["record"].clone()))
            if n_steps:
                self.last_grad, self.last_frames = out["grad"], out["frames"]
            self.step_count += n_steps
            return torch.stack(records) if records else torch.zeros((0, 2))

    def run(self, n_steps: int, seed: int = 0, log_every: int = 10, verbose: bool = True):
        """``n_steps`` steps; each renders with ``fixed_frame``, or else with
        the key ``fold_in(prng_key(seed), step)`` (a fresh realisation per
        step, keyed as the reference's fit loop keys it). Returns the losses,
        read from the device once."""
        first = self.step_count
        rows = self._steps(n_steps, seed).tolist()
        if verbose:
            for i, (loss, gnorm) in enumerate(rows):
                if i % log_every == 0 or i == n_steps - 1:
                    print(f"step {first + i + 1}: loss {loss:.6g} |g| {gnorm:.3g}")
        return [loss for loss, _ in rows]


class PoseFitter:
    """Probe-pose registration: recover the probe position (and, with
    ``fit_angles``, its angles) whose rendered B-mode matches a target.

    ``render_fn(key, position, angles) -> bmode`` renders one frame; the key
    is a (2,) key of ``utils/rng.py``. ``render_batch_fn(keys (B, 2),
    positions (B, 3), angles (B, 3)) -> (B, H, W)``, where given, renders B
    frames, each at its own pose, in one batched call. The tensors live where
    ``init_position`` lives; ``from_simulator`` renders through a
    ``Simulator`` on its device and gives both. Two methods, as the reference's:

    - ``method="fd"``, the registration method: central differences on a
      speckle-robust objective, the pixel MSE between multi-scale Gaussian-
      blurred, K-key compounded B-modes (``keys``, default
      ``split(prng_key(42), 4)``; ``scales``). The 2d + 1 points x K keys are
      rendered with no graph in one ``render_batch_fn`` call, frame (p, k)
      at point p's pose with key k, as the reference's ``vmap`` of a
      ``vmap`` renders them; a fitter given only ``render_fn`` renders them
      one after another. Adam's rate decays as
      ``lr * lr_decay**k`` at its k-th update (counted from 0 across ``run``
      calls, ``optax.exponential_decay(lr, 1, lr_decay)``), and the step
      ``delta = max(fd_delta_min, fd_delta * fd_decay**i)`` anneals over the
      i-th step of each ``run`` call; angles step by ``fd_delta_angles``
      degrees. The target must be the K-key compound rendered with the same
      keys (``compound``).
    - ``method="ad"``: Adam at a constant rate on the gradient of plain pixel
      MSE through the renderer into ``position`` (and ``angles``); the
      reference keeps it as a baseline, not a reliable registration method
      (its docstring, ``mcray_tpu/models/trainer.py:169-179``). The key is
      ``fixed_key``, or else ``fold_in(prng_key(seed), step)``, as
      ``MaterialFitter.run`` keys its frames. The target is one frame.
    """

    def __init__(self, render_fn, init_position, init_angles, target, learning_rate: float = 5e-2,
                 fit_angles: bool = False, fixed_key=None, method: str = "ad", keys=None,
                 scales: tuple = (2.0, 4.0, 8.0), fd_delta: float = 0.06,
                 fd_delta_min: float = 0.025, fd_decay: float = 0.95,
                 fd_delta_angles: float = 1.0, lr_decay: float = 0.95,
                 render_batch_fn=None):
        if method not in ("ad", "fd"):
            raise ValueError(f"unknown method {method!r}; expected 'ad' or 'fd'")
        position = torch.as_tensor(init_position, dtype=torch.float32)
        self.device = position.device
        self.render_fn = render_fn
        self.render_batch_fn = render_batch_fn
        self.target = torch.as_tensor(target, device=self.device).detach()
        self.fit_angles = fit_angles
        self.fixed_key = fixed_key
        self.method = method
        self.learning_rate = learning_rate
        self.lr_decay = lr_decay
        self._angles0 = torch.as_tensor(init_angles, dtype=torch.float32,
                                        device=self.device).detach().clone()
        pose = [position.detach()] + ([self._angles0] if fit_angles else [])
        self._vec = torch.cat(pose).clone().requires_grad_(method == "ad")
        self.optimizer = _adam([self._vec], learning_rate)
        self.step_count = 0
        self.last_grad = None
        if method == "fd":
            self.keys = rng.split(rng.prng_key(42), 4) if keys is None else torch.as_tensor(keys)
            self.scales = tuple(scales)
            self.fd = (float(fd_delta), float(fd_delta_min), float(fd_decay),
                       float(fd_delta_angles))
            tmax = max(float(self.target.max()), 1e-20)
            self._tmax = tmax
            self._target_bank = [gaussian_blur(self.target / tmax, s) for s in self.scales]

    @classmethod
    def from_simulator(cls, sim, init_position, init_angles, target, **kw):
        """A fitter rendering through ``sim.render_frame`` (the ad step) and
        ``sim.render_frames`` (the fd step's frames, one batched call) on
        ``sim``'s device."""
        def render_fn(key, position, angles):
            return sim.render_frame(key, position=position, angles=angles)["bmode"]

        def render_batch_fn(keys, positions, angles):
            return sim.render_frames(keys, positions=positions, angles=angles)["bmode"]

        def tensor(x):
            return torch.as_tensor(np.array(x) if isinstance(x, np.ndarray) else x,
                                   dtype=torch.float32, device=sim.device)

        return cls(render_fn, tensor(init_position), tensor(init_angles), target,
                   render_batch_fn=render_batch_fn, **kw)

    @staticmethod
    def compound(render_fn, keys, position, angles) -> torch.Tensor:
        """K-key compounded B-mode: the mean of one frame per key."""
        return torch.stack([render_fn(k, position, angles) for k in keys]).mean(dim=0)

    # --- state, as the reference holds it ---------------------------------
    def _unpack(self, vec):
        return vec[:3], (vec[3:6] if self.fit_angles else self._angles0)

    @property
    def state(self) -> FitState:
        """``materials`` holds the fitted pose: ``{"position"}``, plus
        ``"angles"`` with ``fit_angles``."""
        vec = self._vec.detach().clone()
        params = {"position": vec[:3]}
        if self.fit_angles:
            params["angles"] = vec[3:]
        return FitState(params, _adam_state(self.optimizer, self._vec), self.step_count)

    @property
    def position(self) -> torch.Tensor:
        return self.state.materials["position"]

    @property
    def angles(self) -> torch.Tensor:
        return self.state.materials.get("angles", self._angles0)

    # --- ad ---------------------------------------------------------------
    def step(self, key) -> float:
        """One Adam step on the AD gradient of the frame's pixel MSE (``method="ad"``)."""
        if self.method != "ad":
            raise ValueError("step(key) is the ad method's; the fd method steps through run()")
        self.optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((self.render_fn(key, *self._unpack(self._vec)) - self.target) ** 2)
        loss.backward()
        self.last_grad = self._vec.grad.detach().clone()
        self.optimizer.step()
        self.step_count += 1
        return float(loss.detach())

    # --- fd ---------------------------------------------------------------
    def point_loss(self, vec: torch.Tensor) -> torch.Tensor:
        """The fd objective at pose ``vec``: the sum over the scales of the MSE
        between the blurred compound of the keys' frames / tmax and the
        blurred target / tmax."""
        with torch.no_grad():
            c = self.compound(self.render_fn, self.keys, *self._unpack(vec)) / self._tmax
            return sum(torch.mean((gaussian_blur(c, s) - tb) ** 2)
                       for s, tb in zip(self.scales, self._target_bank))

    def point_losses(self, pts: torch.Tensor) -> torch.Tensor:
        """``point_loss`` at each pose of ``pts`` (P, d): the P x K frames in
        one ``render_batch_fn`` call (frame p K + k at pose p with key k),
        then per point the mean over its keys, the blurs (batched over the
        points) and the MSE, each reduction as ``point_loss`` makes it, so
        the losses equal P calls of it. Without ``render_batch_fn``, P calls."""
        if self.render_batch_fn is None:
            return torch.stack([self.point_loss(p) for p in pts])
        n_pts, k = pts.shape[0], self.keys.shape[0]
        positions = pts[:, :3]
        angles = pts[:, 3:6] if self.fit_angles else self._angles0.expand(n_pts, 3)
        with torch.no_grad():
            frames = self.render_batch_fn(self.keys.repeat(n_pts, 1),
                                          positions.repeat_interleave(k, dim=0),
                                          angles.repeat_interleave(k, dim=0))
            c = torch.stack([frames[p * k : (p + 1) * k].mean(dim=0)
                             for p in range(n_pts)]) / self._tmax
            blurred = [gaussian_blur(c, s) for s in self.scales]
            return torch.stack([sum(torch.mean((b[p] - tb) ** 2)
                                    for b, tb in zip(blurred, self._target_bank))
                                for p in range(n_pts)])

    def fd_gradient(self, delta: float):
        """(the 2d + 1 point losses, the central-difference gradient) at the
        current pose: points vec, vec + dvec_i e_i, vec - dvec_i e_i, with
        dvec = delta for positions and ``fd_delta_angles`` for angles."""
        vec = self._vec.detach()
        d = vec.shape[0]
        dvec = torch.full((d,), delta, dtype=torch.float32, device=self.device)
        dvec[3:] = self.fd[3]
        eye = torch.eye(d, dtype=torch.float32, device=self.device) * dvec[:, None]
        pts = torch.cat([vec[None], vec[None] + eye, vec[None] - eye])
        vals = self.point_losses(pts)
        return vals, (vals[1 : d + 1] - vals[d + 1 :]) / (2.0 * dvec)

    def apply_fd_update(self, g: torch.Tensor) -> None:
        """One Adam update by ``g`` at the decayed rate of its count."""
        k = self.step_count
        lr = np.float32(self.learning_rate) * np.float32(self.lr_decay) ** np.float32(k)
        self.optimizer.param_groups[0]["lr"] = float(lr)
        self._vec.grad = g.detach().to(self._vec)
        self.optimizer.step()
        self._vec.grad = None
        self.last_grad = g.detach().clone()
        self.step_count += 1

    def fd_step(self, i: int):
        """The i-th fd step of a run: (the 2d + 1 point losses, the gradient,
        delta), after the update."""
        d0, dmin, decay, _ = self.fd
        delta = float(np.float32(max(dmin, d0 * decay**i)))
        vals, g = self.fd_gradient(delta)
        self.apply_fd_update(g)
        return vals, g, delta

    def run(self, n_steps: int, seed: int = 0, log_every: int = 10, verbose: bool = True):
        """``n_steps`` steps; returns each step's loss (fd: the loss at the
        pose before the step)."""
        if self.method == "ad":
            return _run_loop(self, self.fixed_key, n_steps, seed, log_every, verbose)
        losses = []
        for i in range(n_steps):
            vals, g, delta = self.fd_step(i)
            losses.append(float(vals[0]))
            if verbose and (i % log_every == 0 or i == n_steps - 1):
                print(f"step {i}: loss {losses[-1]:.6g} |g| {float(torch.linalg.norm(g)):.3g} "
                      f"delta {delta:.3f}")
        return losses


def _run_loop(fitter, fixed, n_steps: int, seed: int, log_every: int, verbose: bool):
    """The reference's fit loop (``mcray_tpu/models/trainer.py:352-370``):
    each step renders with ``fixed``, or else with the key
    ``fold_in(prng_key(seed), step)``; returns the losses."""
    losses = []
    for i in range(n_steps):
        frame = fixed if fixed is not None else rng.fold_in(rng.prng_key(seed), fitter.step_count)
        losses.append(fitter.step(frame))
        if verbose and (i % log_every == 0 or i == n_steps - 1):
            gnorm = float(torch.linalg.norm(fitter.last_grad))
            print(f"step {fitter.step_count}: loss {losses[-1]:.6g} |g| {gnorm:.3g}")
    return losses
