"""The keyed draws' wrapper (``ops/cuda/draws.py``) on the CPU.

On CPU tensors ``keyed_draws`` and ``fold_in`` run the plain composition the
kernels replace on the card (``rng.fold_in`` of the path ids, then
``physics.draw_bounce_randoms``), launch nothing and count nothing; the
wrapper is registered as the kernel ``draws`` with a device event name.
The kernels themselves are held bitwise to this plain version on the card
(``tests/test_torch_cuda.py``); the plain path is held to ``jax.random`` by
``tests/test_torch_rng.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import reference_draws, to_np
from mcray_tpu_torch import config
from mcray_tpu_torch.models.simulator import path_draws
from mcray_tpu_torch.ops import cuda as kernels
from mcray_tpu_torch.ops import physics
from mcray_tpu_torch.ops.cuda import draws
from mcray_tpu_torch.utils import rng
from mcray_tpu_torch.utils.roofline import EVENT_NAMES

N_PATHS = 40
#: every path of a small frame, and a shard-like subset in no order
PATH_IDS = {"all": torch.arange(N_PATHS), "subset": torch.tensor([37, 3, 4, 5, 22, 0, 39])}


def _trace_keys(frames: int) -> torch.Tensor:
    return rng.fold_in(rng.fold_in(rng.prng_key(17), torch.arange(frames)), 0)


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("n_depth", [1, 10])
@pytest.mark.parametrize("ids", list(PATH_IDS))
def test_keyed_draws_on_the_cpu_are_the_plain_composition(frames, n_depth, ids):
    trace_key, path_ids = _trace_keys(frames), PATH_IDS[ids]
    got = draws.keyed_draws(trace_key, path_ids, n_depth)
    path_keys = rng.fold_in(trace_key[:, None, :], path_ids).reshape(-1, 2)
    want = physics.draw_bounce_randoms(path_keys, n_depth)
    assert tuple(got) == draws.FIELDS and set(want) == set(draws.FIELDS)
    for name in draws.FIELDS:
        assert got[name].shape == (n_depth, frames * len(path_ids)), name
        assert torch.equal(got[name], want[name]), name
    # frame-major: frame b's columns are its own draws alone
    last = draws.keyed_draws(trace_key[-1:], path_ids, n_depth)
    for name in draws.FIELDS:
        assert torch.equal(got[name][:, -len(path_ids):], last[name]), name


@pytest.mark.parametrize("keys,data", [
    ("one", "batch"), ("batch", "int"), ("batch", "batch"), ("batch", "scalar"), ("one", "int")])
def test_fold_in_on_the_cpu_is_rng_fold_in(keys, data):
    batch = rng.fold_in(rng.prng_key(5), torch.arange(6))
    k = {"one": rng.prng_key(9), "batch": batch}[keys]
    x = {"batch": torch.arange(6) * 977 + 2**33 + 4, "int": 2**32 + 7,
         "scalar": torch.tensor(11)}[data]
    got = draws.fold_in(k, x)
    want = rng.fold_in(k, x)
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_path_draws_on_the_cpu_equal_the_reference_frame():
    """``path_draws`` through the wrapper: the reference's frame draws
    (``jax.random``), the uniforms bitwise, the normal to erfinv's rounding."""
    cfg = config.small_test_config(transducer_elements=8, samples_per_element=3)
    n = cfg.transducer_elements * cfg.samples_per_element
    got = path_draws(rng.fold_in(rng.prng_key(4), 0)[None], cfg, "cpu")
    want = reference_draws(4, n, cfg.max_depth)
    for name in draws.FIELDS:
        if name == "q_normal":
            np.testing.assert_allclose(to_np(got[name]), want[name], rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(to_np(got[name]), want[name], err_msg=name)


def test_the_cpu_launches_and_counts_no_draws_kernel():
    kernels.reset_launch_counts()
    cfg = config.small_test_config(transducer_elements=4, samples_per_element=2)
    draws.keyed_draws(_trace_keys(2), PATH_IDS["subset"], 3)
    draws.fold_in(rng.prng_key(1), torch.arange(4))
    path_draws(_trace_keys(1), cfg, "cpu")
    assert kernels.launch_counts()["draws"] == 0


def test_draws_is_a_counted_kernel_with_an_event_name():
    """``launch_counts`` names the wrapper ``draws``; its event name is in
    both kernels' names of ``csrc/draws.cu`` and in no other kernel's."""
    kernels.reset_launch_counts()
    kernels.add_launch_counts({"draws": 3}, 2)
    assert kernels.launch_counts()["draws"] == 6
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["draws"] == 0
    event = EVENT_NAMES["draws"]
    csrc = Path(draws.__file__).resolve().parents[2] / "csrc"
    source = (csrc / "draws.cu").read_text()
    for kernel in ("keyed_draws_kernel(", "keyed_draws_fold_in_kernel("):
        assert kernel in source and event in kernel
    others = [p.name for p in csrc.glob("*.cu*") if p.name != "draws.cu"
              and event in p.read_text()]
    assert not others
    assert not [k for k, v in EVENT_NAMES.items() if k != "draws" and event in v]
