"""The chained batch, ``Simulator.make_chained_batch(batch, n_chain)``
(parameters ``batch``, ``n_chain``, ``warm_calls``, ``sample``): a request
is one call from a ``seed0`` drawn from the seed, synchronised (a closed
loop of one caller). It renders ``batch x n_chain`` frames and returns the
last step's ``batch`` B-modes, which are what it is checked on. Its
end-to-end value is ``frames_per_s``: every frame of every call finished in
the window, over the window's seconds."""

from __future__ import annotations

import torch

from benchmark.harness import traffic
from benchmark.reference.frame import chained_keys


class Chained:
    def __init__(self, mix: dict, ctx):
        self.batch, self.n_chain, self.k = mix["batch"], mix["n_chain"], mix["sample"]
        self.units = self.batch * self.n_chain
        self.ctx, self.warm_calls, self.calls = ctx, mix["warm_calls"], 0
        sim = ctx.simulator()
        self.call = sim.make_chained_batch(self.batch, self.n_chain)
        self.launches = traffic.step_launches(sim)
        self.sample = traffic.Reservoir(self.k, ctx.streams["sample"])

    def expect(self) -> dict[str, int]:
        return {k: v * self.n_chain for k, v in self.launches.items()}

    def warm(self) -> None:
        for _ in range(self.warm_calls):
            self.call(traffic.seed_words(self.ctx.streams["requests"]))
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def request(self) -> None:
        seed0 = traffic.seed_words(self.ctx.streams["requests"])
        out = self.call(seed0)
        self.ctx.guard(out)
        self.calls += 1
        slot = self.sample.wants()
        if slot is not None:
            self.sample.items[slot] = {"seed0": seed0, "bmode": out.clone()}
        if out.is_cuda:
            torch.cuda.synchronize()

    def measured(self, units: int, elapsed_s: float) -> dict[str, float]:
        return {"frames_per_s": units / elapsed_s}

    def free(self) -> None:
        self.call = None

    def keys(self) -> list[torch.Tensor]:
        """The frame keys of each sampled call's checked (last) step."""
        return [chained_keys(item["seed0"], self.batch, self.n_chain - 1, self.ctx.device)
                for item in self.sample.items]

    def compare(self) -> list[tuple]:
        return [(item["bmode"], self.ctx.reference.render(keys))
                for item, keys in zip(self.sample.items, self.keys())]

    def expected(self) -> int:
        return min(self.k, self.calls) * self.batch


def make(mix: dict, ctx) -> Chained:
    return Chained(mix, ctx)
