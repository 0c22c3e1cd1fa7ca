"""Multi-process initialisation and the global mesh.

Port of ``mcray_tpu/parallel/multihost.py``: after ``initialize()``, every
process is one rank of the default process group, holding one device, and
the same ``parallel/shard.py`` code runs on each — scanlines sharded over
all ranks, the RF ``all_gather`` and the material-gradient ``all_reduce``
over NCCL between GPUs (gloo between CPU processes). Nothing on a machine
tells a process of its cluster: give ``initialize`` the coordinator's
address, the process count and this process's id, or start the processes
with ``torchrun``, which sets them in the environment, and call
``initialize()`` with no arguments.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .shard import backend_for, make_mesh


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda") -> None:
    """Join the default process group: NCCL for ``device="cuda"`` (after
    ``torch.cuda.set_device`` to the local rank: ``LOCAL_RANK``, else the
    process id modulo the visible cards), gloo for ``"cpu"``, rendezvous at
    ``tcp://coordinator_address`` (``host:port``), or from the environment
    that ``torchrun`` sets where no address is given. A no-op for a single
    process (``num_processes <= 1``), as in JAX."""
    if num_processes is not None and num_processes <= 1:
        return
    backend = backend_for(device)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        if local is None and process_id is not None:
            local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(int(local or 0))
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def global_mesh(axis: str = "rays", *, device="cuda"):
    """1-D mesh over every rank of every process."""
    return make_mesh(axis=axis, device=device)


def is_primary() -> bool:
    """Whether this is rank 0 (or the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
