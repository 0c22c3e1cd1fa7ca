"""One step on device buffers, replayed from a CUDA graph: what the chained
batch (``simulator.ChainedBatch``) and the material fit
(``trainer.MaterialFitter``) share.

On the card ``capture`` (which the first ``run`` calls) loads the kernel
library, outside any span (a checkout's first run builds it). Then, in the
span ``<name>.capture``, it runs the step once eagerly on a side stream,
which builds the kernels' caches and whatever state the step makes at its
first call, inside ``around_warmup`` (the fit puts its state back there).
It then captures one step into a ``torch.cuda.CUDAGraph`` with a memory
pool of its own and counts the graph's nodes. The counters
``<name>.graph_nodes`` and ``<name>.graph_frames`` (once, at capture) count
what a replay hides. The launches the capture made are tallied apart
(``launches``, by kernel), since none of them ran.

``run(n)`` replays the graph ``n`` times, each replay the span
``<name>.replay``, and adds ``launches`` ``n`` times to
``ops.cuda.launch_counts``. Its outputs are the graph's buffers, which the
next replay overwrites. The graph reads the tensors the step read at
capture; a capture or replay that fails raises, and nothing then runs the
step eagerly on the card. On the CPU ``run`` calls the step ``n`` times
and captures nothing.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..ops.cuda import _build, add_launch_counts
from ..utils import profiling


class GraphStep:
    """``step()`` (no arguments; it reads and advances device buffers and
    returns its outputs) on ``device``, named ``name`` in its spans and
    counters, rendering ``frames`` frames a step."""

    def __init__(self, step: Callable, device, name: str, frames: int,
                 around_warmup: Callable = contextlib.nullcontext):
        self.step, self.device, self.name, self.frames = step, torch.device(device), name, frames
        self.around_warmup = around_warmup
        self.graph = None
        self._out = None
        #: the captured step's kernel launches, by kernel (``launch_counts``' names)
        self.launches = {}

    def capture(self) -> None:
        """Capture the step, once, on the card; nothing on the CPU. Call it
        before writing the buffers a call starts from: the warm-up step
        advances them."""
        if self.device.type != "cuda" or self.graph is not None:
            return
        device = self.device
        _build.library()
        with profiling.span(f"{self.name}.capture", units=self.frames):
            with self.around_warmup():
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    self.step()
                torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with _build.tallied() as launches, torch.cuda.graph(graph):
                out = self.step()
                nodes = profiling.capture_nodes(device)
            torch.cuda.synchronize(device)
        profiling.count(f"{self.name}.graph_nodes", nodes)
        profiling.count(f"{self.name}.graph_frames", self.frames)
        self.graph, self._out, self.launches = graph, out, dict(launches)

    def run(self, n: int, each: Callable | None = None):
        """``n`` steps, capturing first where the card has no graph yet;
        hands each step's outputs to ``each``. Returns the last step's
        outputs (None for ``n`` 0)."""
        self.capture()
        out = None
        for _ in range(n):
            if self.graph is None:  # the CPU
                out = self.step()
            else:
                with profiling.span(f"{self.name}.replay", units=self.frames):
                    self.graph.replay()
                out = self._out
            if each is not None:
                each(out)
        if self.graph is not None:
            add_launch_counts(self.launches, n)
        return out
