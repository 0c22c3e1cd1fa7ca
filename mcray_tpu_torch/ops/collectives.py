"""Differentiable collectives over a ``torch.distributed`` process group.

The three moves of the reference's ``shard_map`` bodies
(``mcray_tpu/parallel/shard.py``, ``mcray_tpu/ops/imaging.py:130-227``),
each an ``autograd.Function`` whose backward is the transpose that JAX
derives for it:

- ``shift_blocks``: every rank receives the block of the next rank along
  the group, wrapping around (``ppermute`` with ``j -> j - 1``); backward
  sends each gradient back to the block's owner (``j -> j + 1``). By P2P
  (``batch_isend_irecv``); on a one-rank group the block is the rank's own.
- ``gather_blocks``: the blocks of all ranks concatenated in rank order
  (``all_gather(tiled=True)``); backward keeps this rank's slice of the
  cotangent. That transpose holds because every rank computes the same
  thing from the gathered tensor, so every rank holds the same cotangent:
  summing the cotangents, as ``torch.distributed.nn``'s gather does, would
  count the gradient world-size times.
- ``sum_blocks``: the sum over the group (``psum``); backward passes the
  cotangent through, for the same reason.

Ranks are positions in ``group`` (``None``: the default group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _exchange(x: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    """Send ``x`` to group rank ``send_to`` and receive a tensor like it from
    ``recv_from``; on a one-rank group, ``x`` itself (torch refuses a send
    to self)."""
    if dist.get_world_size(group) == 1:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, send_to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, recv_from), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _neighbours(group) -> tuple[int, int]:
    """(previous, next) group rank, wrapping around."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    return (me - 1) % n, (me + 1) % n


class _ShiftBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        prev, nxt = _neighbours(group)
        return _exchange(x, group, prev, nxt)

    @staticmethod
    def backward(ctx, g):
        prev, nxt = _neighbours(ctx.group)
        return _exchange(g, ctx.group, nxt, prev), None


def shift_blocks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The next rank's ``x`` (the last rank gets rank 0's)."""
    return _ShiftBlocks.apply(x, group)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.size, ctx.size).contiguous(), None, None


def gather_blocks(x: torch.Tensor, group=None, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return _GatherBlocks.apply(x, group, dim)


class _SumBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_blocks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``."""
    return _SumBlocks.apply(x, group)
