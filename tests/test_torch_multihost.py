"""Two processes joined by ``mcray_tpu_torch.parallel.multihost``, as
``tests/test_multihost.py`` runs the reference's.

Each process (``tests/torch_shard_worker.py multihost``, torch and the port
only, one thread) calls ``multihost.initialize`` with the coordinator's
address, the process count and its id over gloo, checks ``is_primary``,
renders the sphere's frame of seed 0 with ``ShardedRenderer`` over
``global_mesh()`` (the RF-column ``all_gather`` crossing the process
boundary) against its own single-device ``Simulator`` (RF columns bitwise,
B-mode rtol 1e-5 / atol 1e-6), then takes one sharded train step, whose
gradient ``all_reduce`` crosses it too; a failed check exits non-zero.
"""

import numpy as np
import torch

from _torch_port import collect_ranks, spawn_ranks
from mcray_tpu_torch.parallel import multihost


def test_single_process_needs_no_group():
    multihost.initialize("127.0.0.1:1", 1, 0, device="cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary()


def test_two_process_sharded_render_and_train_step(tmp_path):
    ranks = collect_ranks(spawn_ranks("multihost", 2, tmp_path), tmp_path)
    np.testing.assert_array_equal(ranks[0]["bmode"], ranks[1]["bmode"])
    assert float(ranks[0]["loss"]) == float(ranks[1]["loss"])
