"""The material fit, ``MaterialFitter.run`` (parameters ``n_frames_per_step``,
``n_steps``, ``trained_rows``, ``trained_columns``, ``start_spread``,
``learning_rate``, ``warm_calls``, ``sample``): a request is one fit of
``n_steps`` steps from a start and a seed of its own, drawn from the
requests stream, synchronised (a closed loop of one caller). A step renders
``n_frames_per_step`` frames of its own keys, differentiates their mean's
pixel MSE against the target into the material table, masks the gradient to
the trained entries, and takes an Adam step. The target is the compound of
``n_frames_per_step`` frames of keys from the scene stream at the scene's
own table, rendered once at set-up; a start is the scene's table with each
trained entry times a factor drawn log-uniform in ``start_spread`` from the
request's seed, Adam's moments zero. The end-to-end value is
``frames_per_s``: the frames rendered and differentiated in the window,
over its seconds.

A request runs its steps as two calls of ``run``, all but the last step,
then the last, so that the state before the last step is read between them
(the first call has read its losses from the card, so the copy waits on
nothing). Each sampled request is checked on its last step, three answers
against the reference's step from the program's table and moments before
that step and the step count the request implies: the step's frames, its
masked gradient (one row) and its update (the table after it less the
table before it, one row).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import traffic
from benchmark.harness.roofline import EVENT_NAMES
from benchmark.reference import rng as ref_rng
from benchmark.reference.fit import FitReference


def step_keys(seed: int, step: int, n_frames: int, device) -> torch.Tensor:
    """The (n_frames, 2) frame keys of step ``step`` of a fit from ``seed``:
    ``split(fold_in(prng_key(seed), step), n_frames)``."""
    return ref_rng.split(ref_rng.fold_in(ref_rng.prng_key(seed), step), n_frames).to(device)


class Fit:
    def __init__(self, mix: dict, ctx):
        from mcray_tpu_torch.models.trainer import MaterialFitter

        self.n_frames, self.n_steps, self.k = mix["n_frames_per_step"], mix["n_steps"], mix["sample"]
        self.rows, self.cols = mix["trained_rows"], mix["trained_columns"]
        self.spread, self.lr = mix["start_spread"], mix["learning_rate"]
        self.units = self.n_frames * self.n_steps
        self.ctx, self.warm_calls, self.calls = ctx, mix["warm_calls"], 0
        sim = ctx.simulator()
        self.table = sim.materials.detach().clone()
        keys = ref_rng.split(ref_rng.prng_key(traffic.seed_words(ctx.streams["scene"])),
                             self.n_frames)
        with torch.no_grad():
            self.target = sim.render_compound(keys)
        self.fit = MaterialFitter.from_simulator(sim, self.table, self.target,
                                                 learning_rate=self.lr, trainable=self.cols,
                                                 trainable_rows=self.rows,
                                                 n_frames_per_step=self.n_frames)
        self.mask = self.fit.mask
        self.launches = {**traffic.step_launches(sim),
                         EVENT_NAMES["march_bwd"]: 1, EVENT_NAMES["scanconv_bwd"]: 1,
                         # the step's key and its frames' keys, the frames' trace keys; the draws
                         "keyed_draws_fold_in_kernel": 3, "keyed_draws_kernel": 1}
        self.sample = traffic.Reservoir(self.k, ctx.streams["sample"])

    def start(self, seed: int):
        """The start of the fit of ``seed``: (table, zero moments, step 0)."""
        from mcray_tpu_torch.models.trainer import FitState

        lo, hi = np.log(self.spread[0]), np.log(self.spread[1])
        factors = np.ones(tuple(self.table.shape), np.float32)
        factors[np.ix_(self.rows, self.cols)] = np.exp(np.random.default_rng(seed).uniform(
            lo, hi, (len(self.rows), len(self.cols))))
        table = self.table * torch.from_numpy(factors).to(self.table.device)
        zeros = torch.zeros_like(table)
        return FitState(table, {"exp_avg": zeros, "exp_avg_sq": zeros, "step": 0}, 0)

    def expect(self) -> dict[str, int]:
        return {k: v * self.n_steps for k, v in self.launches.items()}

    def one(self, seed: int) -> dict:
        """One fit from ``seed``: the state before its last step, its last
        step's frames and masked gradient, and the table after it."""
        self.fit.state = self.start(seed)
        self.fit.run(self.n_steps - 1, seed, verbose=False)
        before = self.fit.state
        self.fit.run(1, seed, verbose=False)
        return {"seed": seed, "before": before, "frames": self.fit.last_frames,
                "grad": self.fit.last_grad}

    def warm(self) -> None:
        for _ in range(self.warm_calls):
            self.one(traffic.seed_words(self.ctx.streams["requests"]))
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def request(self) -> None:
        out = self.one(traffic.seed_words(self.ctx.streams["requests"]))
        self.ctx.guard(out["frames"])
        self.calls += 1
        slot = self.sample.wants()
        if slot is not None:
            self.sample.items[slot] = {**out, "frames": out["frames"].clone(),
                                       "grad": out["grad"].clone(),
                                       "after": self.fit.state.materials}
        if out["frames"].is_cuda:
            torch.cuda.synchronize()

    def measured(self, units: int, elapsed_s: float) -> dict[str, float]:
        return {"frames_per_s": units / elapsed_s}

    def free(self) -> None:
        self.fit = None

    def reference(self) -> FitReference:
        c = self.ctx
        return FitReference(c.acq, c.scene_path, c.mesh_dir, c.texture_seed, c.device)

    def answers(self, item: dict, ref: FitReference, control: bool = False) -> dict:
        """The reference's last step of the sampled fit ``item``."""
        before = item["before"]
        keys = step_keys(item["seed"], self.n_steps - 1, self.n_frames, self.ctx.device)
        return ref.step(before.materials, before.opt_state["exp_avg"],
                        before.opt_state["exp_avg_sq"], self.n_steps - 1, keys, self.target,
                        self.mask, self.lr, control)

    def compare(self) -> list[tuple]:
        ref, pairs = self.reference(), []
        for item in self.sample.items:
            want = self.answers(item, ref)
            update = item["after"] - item["before"].materials
            pairs += [(item["frames"], {"bmode": want["bmode"], "segments": want["segments"]}),
                      (item["grad"].reshape(1, -1), {"bmode": want["grad"].reshape(1, -1)}),
                      (update.reshape(1, -1), {"bmode": want["update"].reshape(1, -1)})]
        return pairs

    def expected(self) -> int:
        return min(self.k, self.calls) * (self.n_frames + 2)


def make(mix: dict, ctx) -> Fit:
    return Fit(mix, ctx)
