"""The sequential peak-lerp walk against both packages' envelopes.

``_torch_port.envelope_walk`` transcribes the C++ loop row by row. The
reference's ``imaging.envelope`` (jnp, two associative scans) and the port's
``imaging.envelope`` (a running maximum and a reverse running minimum) are
its closed form. Columns drawn from a few levels, so that equal neighbours
and plateaus are the common case, go through all three: the port's equals
the walk bitwise (the same float32 expression per row), the reference's to
rtol 1e-6 / atol 1e-7 (XLA may contract the lerp's multiply and add). This
holds the closed form in plain PyTorch; the CUDA kernel's warp scans are
held against it only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import envelope_walk, to_np, to_torch
from mcray_tpu.ops import imaging as ref_imaging
from mcray_tpu_torch.ops import imaging

LEVELS = np.array([-2.0, -1.0, -0.5, 0.0, 0.25, 0.5, 1.0, 2.0, 3.0], np.float32)


def _columns(rows: int, seed: int) -> np.ndarray:
    """(rows, 40) columns of LEVELS, the first few made by hand: falling and
    rising (no peak), flat, a peak at row 1 and a peak at row rows - 2."""
    rng = np.random.default_rng(seed)
    img = LEVELS[rng.integers(0, len(LEVELS), (rows, 40))]
    ramp = np.linspace(3.0, -2.0, rows, dtype=np.float32)
    img[:, 0], img[:, 1], img[:, 2] = ramp, ramp[::-1], 0.25
    img[:, 3] = ramp
    img[1, 3] = 4.0
    img[:, 4] = ramp[::-1] - 6.0
    img[rows - 2, 4] = 4.0
    return img


@pytest.mark.parametrize("rows", [3, 4, 5, 7, 12, 48, 465])
def test_both_envelopes_equal_the_sequential_walk(rows):
    img = _columns(rows, seed=rows)
    want = np.stack([envelope_walk(img[:, c]) for c in range(img.shape[1])], axis=1)
    assert rows < 5 or not np.array_equal(want[:, 5:], img[:, 5:])  # the walk did lerp somewhere
    np.testing.assert_array_equal(to_np(imaging.envelope(to_torch(img))), want)
    np.testing.assert_allclose(np.asarray(ref_imaging.envelope(jnp.asarray(img))), want,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rows", [1, 2])
def test_fewer_than_three_rows_stay_raw(rows):
    img = _columns(8, seed=0)[:rows]
    np.testing.assert_array_equal(envelope_walk(img[:, 0]), img[:, 0])
    np.testing.assert_array_equal(to_np(imaging.envelope(to_torch(img))), img)
