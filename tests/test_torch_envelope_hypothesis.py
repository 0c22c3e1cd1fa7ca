"""Property test: the port's closed-form envelope equals the sequential
peak-lerp walk (``_torch_port.envelope_walk``) bitwise on drawn columns with
plateaus, equal neighbours, no peak, a peak at row 1 and at row R - 2, and
fewer than 3 rows. ``tests/test_torch_envelope_walk.py`` holds the walk
against the reference's jnp envelope on seeded columns. Skipped where
``hypothesis`` is not installed.
"""

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")

from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from _torch_port import envelope_walk, to_np, to_torch  # noqa: E402
from mcray_tpu_torch.ops import imaging  # noqa: E402

# few distinct levels: equal neighbours and plateaus are the common case
_LEVELS = st.sampled_from([-2.0, -1.0, -0.5, 0.0, 0.25, 0.5, 1.0, 2.0, 3.0])


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.lists(_LEVELS, min_size=0, max_size=48))
@example([])                                      # rows < 3: the walk never starts
@example([1.0])
@example([0.5, 2.0])
@example([0.0, 3.0, 1.0, 0.5, 0.25])              # a peak at row 1
@example([2.0, 1.0, 0.5, 0.25, 3.0, 0.0])         # a peak at row R - 2
@example([3.0, 2.0, 1.0, 0.5, 0.25, 0.0])         # falling: no peak
@example([0.0, 0.5, 1.0, 2.0, 3.0])               # rising to the last row: no peak
@example([1.0, 1.0, 1.0, 1.0])                    # flat
@example([0.0, 2.0, 2.0, 2.0, 1.0, 3.0, 3.0, 0.5])  # plateaus after a rise
def test_envelope_scan_form_equals_the_sequential_walk(levels):
    col = np.array(levels, np.float32)
    want = envelope_walk(col)
    got = to_np(imaging.envelope(to_torch(col.reshape(-1, 1))))[:, 0]
    np.testing.assert_array_equal(got, want)
