"""A run of ``sphere.chained``, driven on the CPU at ``small_test_config()``
sizes past the look for a card: its result line has the contract's keys, a sound program comes out
correct, and a program broken underneath comes out not correct, once for
each fault the cell can have: a step that returns its state unchanged (the
previous answer), half of the batch left out (its answers copied from the
other half), an answer altered where it is produced. Without a card the
command prints no result and exits non-zero."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import cell, runner
from benchmark.tests.helpers import SMALL
from mcray_tpu_torch.models import simulator

CHAINED_MIX = {"batch": 2, "n_chain": 2, "warm_calls": 1, "sample": 2}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def run(name="sphere.chained", seconds=1.5, mix=CHAINED_MIX):
    return runner.run_cell(name, 2**31 + 4242, seconds, False, t_start=time.perf_counter(),
                           device="cpu", acquisition=SMALL, mix=mix)["result"]


def stale(orig):
    def call(self, *args, **kw):
        out = orig(self, *args, **kw)
        prev = getattr(self, "_stale", out)
        self._stale = out
        return prev
    return call


def half(orig):
    def call(self, *args, **kw):
        out = orig(self, *args, **kw).clone()
        out[out.shape[0] // 2:] = out[: out.shape[0] - out.shape[0] // 2]
        return out
    return call


def altered(orig):
    def call(self, *args, **kw):
        out = orig(self, *args, **kw).clone()
        out[0] *= 1.1
        return out
    return call


def test_a_sound_run_is_correct_and_its_line_has_the_contracts_keys():
    result = run()
    assert list(result) == KEYS
    assert result["correct"] and result["failed"] == 0
    assert result["check"]["rel_l2_max"]["value"] == 0.0
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in result["check"].values())


@pytest.mark.parametrize("fault", [stale, half, altered], ids=lambda f: f.__name__)
def test_a_broken_chained_batch_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(simulator.ChainedBatch, "__call__",
                        fault(simulator.ChainedBatch.__call__))
    assert not run()["correct"]


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, os.path.join(cell.BENCH, "run.py"), "--workload",
                           "sphere.chained", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, cwd=cell.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
