"""Sums over the ranks of a torch.distributed process group: the port's
counterpart of the JAX package's `psum` over a mesh axis.

A sharded solve holds one block of the edges (or query rows) on each rank;
every quantity summed over them is all-reduced at the place where the JAX
solver psums it, so every rank solves the same global system. Under NCCL
the collective is enqueued on the current stream and reads nothing back to
the host; under gloo (ranks on the CPU) it runs in place before returning.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`'s ranks, in place; with group None, x as is."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def require_group(group=None):
    """`group`, or the default group when None; raises when no process
    group is initialized (a sharded solve never runs unsharded)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialized: call "
            "dist.init_process_group (nccl, one rank per card; gloo on the "
            "CPU) before a sharded solve")
    return dist.group.WORLD if group is None else group


def rank_block(x, n: int, fill, group):
    """This rank's contiguous block of x's first axis, after padding it
    from n rows to a multiple of the group's size with `fill` (None stays
    None)."""
    if x is None:
        return None
    world = dist.get_world_size(group)
    per = -(-n // world)
    if per * world > n:
        pad = torch.full((per * world - n,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    r = dist.get_rank(group)
    return x[r * per:(r + 1) * per]
