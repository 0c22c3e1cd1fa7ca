"""The keyed draws as one kernel (``csrc/draws.cu``), and ``fold_in`` over a
batch of keys.

Replaces no TPU kernel: the reference draws with ``jax.random``, which XLA
fuses. The plain version is the port's reference composition, ``rng.fold_in``
of the path ids and ``physics.draw_bounce_randoms`` (``utils/rng.py``: threefry
as ~146 elementwise int64 ops a cipher pass, nine passes a chained step).
``keyed_draws_kernel`` runs the whole key chain of a path-bounce in uint32
registers, one thread per (depth, column), and writes the five fields bit for
bit the plain path's on the card (the source's note has the chain and the
bound); ``keyed_draws_fold_in_kernel`` derives a batch of keys in one launch.

Both count under ``draws`` (``launch_counts``): a chained step makes three (its frame keys, the
frames' trace keys, the draws), an eager frame one (its keys are derived on
the host). Nothing is differentiable here.
"""

from __future__ import annotations

import torch

from ...utils import rng
from .. import physics
from . import _build


#: the five fields, in the order of the kernel's (5, D, N) buffer
FIELDS = ("q_normal", "angle_u", "axis_u", "radius_u", "roulette_u")


def keyed_draws_plain(trace_key: torch.Tensor, path_ids: torch.Tensor,
                      n_depth: int) -> dict[str, torch.Tensor]:
    """Plain version: ``physics.draw_bounce_randoms`` of the path keys
    ``fold_in(trace_key[b], path_ids[p])``, frame-major."""
    path_keys = rng.fold_in(trace_key[:, None, :], path_ids)
    return physics.draw_bounce_randoms(path_keys.reshape(-1, 2), n_depth)


def keyed_draws(trace_key: torch.Tensor, path_ids: torch.Tensor,
                n_depth: int) -> dict[str, torch.Tensor]:
    """The ``(n_depth, B x P)`` fields of ``physics.draw_bounce_randoms`` for
    the B trace keys ``trace_key`` (B, 2) and the P paths ``path_ids`` (P,)
    (int64 holding uint32 words; any subset of a frame's paths): column
    b P + p is path ``path_ids[p]`` of frame b. The kernel for CUDA tensors
    (the five fields views of one (5, n_depth, B x P) buffer), the plain
    version for CPU ones."""
    if trace_key.device.type == "cpu" and path_ids.device.type == "cpu":
        return keyed_draws_plain(trace_key, path_ids, n_depth)
    if trace_key.dim() != 2 or trace_key.shape[1] != 2:
        raise ValueError(f"trace_key: expected (B, 2), got {tuple(trace_key.shape)}")
    if path_ids.dim() != 1:
        raise ValueError(f"path_ids: expected (P,), got {tuple(path_ids.shape)}")
    _build.require(trace_key, "trace_key", torch.int64)
    _build.require(path_ids, "path_ids", torch.int64)
    if path_ids.device != trace_key.device:
        raise ValueError(f"path_ids on {path_ids.device}, trace_key on {trace_key.device}")
    b, p = trace_key.shape[0], path_ids.shape[0]
    out = torch.empty((len(FIELDS), n_depth, b * p), dtype=torch.float32,
                      device=trace_key.device)
    _build.launch("mcray_keyed_draws", trace_key.data_ptr(), b, path_ids.data_ptr(), p, n_depth,
                  out.data_ptr(), device=trace_key.device)
    return dict(zip(FIELDS, out))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``rng.fold_in(keys, data)`` for keys (2,) or (K, 2) and ``data`` an int
    or an int64 tensor (), (1,) or (K,): one kernel launch for CUDA keys, the
    plain ``rng.fold_in`` for CPU ones. Returns (K, 2) int64 (the broadcast
    of the two; a (2,) key with an int data gives (2,))."""
    if keys.device.type == "cpu":
        return rng.fold_in(keys, data)
    if keys.dim() not in (1, 2) or keys.shape[-1] != 2:
        raise ValueError(f"keys: expected (2,) or (K, 2), got {tuple(keys.shape)}")
    _build.require(keys, "keys", torch.int64)
    n_keys = keys.shape[0] if keys.dim() == 2 else 1
    tensor = isinstance(data, torch.Tensor)
    if tensor:
        if data.dim() > 1:
            raise ValueError(f"data: expected (), (1,) or (K,), got {tuple(data.shape)}")
        _build.require(data, "data", torch.int64)
        if data.device != keys.device:
            raise ValueError(f"data on {data.device}, keys on {keys.device}")
    n_data = data.numel() if tensor else 1
    n = max(n_keys, n_data)
    if n_keys not in (1, n) or n_data not in (1, n) or n == 0:
        raise ValueError(f"keys ({n_keys}) and data ({n_data}) do not broadcast to a batch")
    batched = keys.dim() == 2 or (tensor and data.dim() == 1)
    out = torch.empty((n, 2) if batched else (2,), dtype=torch.int64, device=keys.device)
    _build.launch(
        "mcray_fold_in", keys.data_ptr(), int(n_keys > 1), data.data_ptr() if tensor else None,
        int(n_data > 1), 0 if tensor else int(data) & rng._MASK32, n, out.data_ptr(),
        device=keys.device)
    return out
