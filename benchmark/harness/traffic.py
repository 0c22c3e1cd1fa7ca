"""The one generator of the benchmark's traffic. A mix is a data file
(``traffic/<mix>.json``) whose ``entry`` names the entry point of the
program that serves its requests, ``entries/<entry>.py``, with that entry's
parameters; the seeds of every request come from the run's seed.

An entry's ``make(mix, ctx)`` (``ctx``: ``runner.Context``) builds the
program and returns the workload the run drives:

- ``warm()``: set-up, every shape the window uses;
- ``request()``: one request, finished (synchronised) when it returns; the
  count of its units (frames) is ``units``;
- ``expect()``: the hand-written kernels' launches a request makes, by
  device event name (the traced view's check that no event was lost);
- ``measured(units, elapsed_s)``: the entry's end-to-end values over the
  window, by metric name (the run adds ``setup_s``);
- ``free()``: drops the program's state before the reference runs;
- ``compare()``: (the program's answer, the reference's output) of each
  sampled request, the reference's a dict with ``bmode`` and ``segments``;
  ``expected()``: how many answers (rows of those) the sample has to hold.

Every answer of every request is counted by a ``Guard`` on the device.
This module holds what the entries share.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cell
from .roofline import EVENT_NAMES

#: the closest-hit kernels a bounce launches, by ``Simulator.intersect``
CLOSEST_HIT = {"listed": ("intersect_listed",), "culled": ("intersect_culled",),
               "staged": ("intersect_staged",), "grouped": ("intersect_grouped", "intersect_listed"),
               "bvh": ("bvh_intersect",), "brute": ("intersect",)}


def make(mix: dict, ctx):
    """The workload of the mix ``mix``, by its ``entry``."""
    return cell.entry(mix["entry"])(mix, ctx)


def step_launches(sim) -> dict[str, int]:
    """The hand-written kernels' launches of one batched frame step, by device
    event name: the closest hit each bounce, then the march, the postproc and
    the scan conversion once."""
    out = {EVENT_NAMES[k]: sim.cfg.max_depth for k in CLOSEST_HIT[sim.intersect]}
    return {**out, **{EVENT_NAMES[k]: 1 for k in ("march", "postproc", "scanconv")}}


class Guard:
    """A device count of the frames that are not finite, have a negative
    pixel, or light a pixel outside the fan."""

    def __init__(self, outside: torch.Tensor):
        self.outside = outside
        self.bad = torch.zeros((), dtype=torch.int64, device=outside.device)

    def __call__(self, bmode: torch.Tensor) -> None:
        ok = (torch.isfinite(bmode).all(dim=(1, 2)) & (bmode.amin(dim=(1, 2)) >= 0.0)
              & (bmode.masked_fill(~self.outside, 0.0).abs().amax(dim=(1, 2)) == 0.0))
        self.bad += (~ok).sum()


class Reservoir:
    """A uniform sample of ``k`` of the requests offered, by the seed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def wants(self) -> int | None:
        """The slot the next request goes into, or None; counts it offered."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(self.seen))
        return j if j < self.k else None


def seed_words(rng: np.random.Generator, n: int | None = None):
    """uint32 seeds as Python ints."""
    if n is None:
        return int(rng.integers(2**32))
    return [int(s) for s in rng.integers(2**32, size=n)]
