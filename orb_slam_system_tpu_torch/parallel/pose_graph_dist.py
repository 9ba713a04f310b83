"""The essential graph with its edges sharded over ranks.

Port of orb_slam_system_tpu/parallel/pose_graph_dist.py. The JAX module
shards the edge list of `optimize_essential_graph` over a device mesh with
`shard_map`; here each rank of a torch.distributed process group holds a
contiguous block of the edges while the Sim3 vertices are replicated, and
the solver sums the gradient, the block-Jacobi diagonal, the PCG matvec and
the LM costs over the group, so every rank takes the same steps and
returns the same result.
"""

from __future__ import annotations

import torch

from orb_slam_system_tpu_torch.solvers.pose_graph import (
    optimize_essential_graph)
from orb_slam_system_tpu_torch.utils.collectives import (rank_block,
                                                         require_group)


def optimize_essential_graph_sharded(R0, t0, s0, v_fixed, v_valid,
                                     e_i, e_j, e_R, e_t, e_s, e_valid,
                                     n_iters: int = 20, cg_iters: int = 50,
                                     group=None):
    """optimize_essential_graph's contract with the edges split over
    `group` (the default group when None): the edge list is padded to a
    multiple of the group's size with invalid edges (the JAX module's
    fills: e_valid False, e_s 1, the rest 0) and this rank solves with its
    contiguous block. Every rank returns the same (R, t, s). Raises without
    a process group."""
    group = require_group(group)
    E = e_i.shape[0]

    def block(x, fill):
        return rank_block(torch.as_tensor(x), E, fill, group)
    return optimize_essential_graph(
        R0, t0, s0, v_fixed, v_valid, block(e_i, 0), block(e_j, 0),
        block(e_R, 0.0), block(e_t, 0.0), block(e_s, 1.0),
        block(e_valid, False), n_iters=n_iters, cg_iters=cg_iters,
        group=group)
