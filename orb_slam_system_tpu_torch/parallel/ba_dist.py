"""The global bundle adjustment with its edges sharded over ranks.

Port of orb_slam_system_tpu/parallel/ba_dist.py. The JAX module shards
the EDGE list of `bundle_adjust_cg` over a device mesh with `shard_map`;
here each rank of a torch.distributed process group (one per card under
NCCL, or ranks on the CPU under gloo) holds a contiguous block of the
edges while cameras and points are replicated, and the solver sums every
edge-reduced quantity (normal-equation blocks, gradients, both halves of
the Schur matvec, robust costs) over the group, so every rank takes the
same steps and returns the same result.

Per CG iteration two [C,6]-or-[P,3] sums cross the group: small next to the
edge work, which is split E / world ways.
"""

from __future__ import annotations

from orb_slam_system_tpu_torch.solvers.local_ba import (BAProblem,
                                                        bundle_adjust_cg)
from orb_slam_system_tpu_torch.utils.collectives import (rank_block,
                                                         require_group)


def bundle_adjust_cg_sharded(prob: BAProblem, fx, fy, cx, cy,
                             n_iters: int = 10, cg_iters: int = 40,
                             group=None):
    """bundle_adjust_cg's contract with the edges split over `group` (the
    default group when None): the edge list is padded to a multiple of the
    group's size with invalid edges (e_valid False, e_ur -1, the JAX
    module's fills) and this rank solves with its contiguous block. Every
    rank returns the same (Tcw, points). Raises without a process group."""
    group = require_group(group)
    E = prob.e_cam.shape[0]
    local = prob._replace(
        e_cam=rank_block(prob.e_cam, E, 0, group),
        e_pt=rank_block(prob.e_pt, E, 0, group),
        e_uv=rank_block(prob.e_uv, E, 0.0, group),
        e_inv_sigma2=rank_block(prob.e_inv_sigma2, E, 0.0, group),
        e_valid=rank_block(prob.e_valid, E, False, group),
        e_ur=rank_block(prob.e_ur, E, -1.0, group))
    return bundle_adjust_cg(local, fx, fy, cx, cy, n_iters=n_iters,
                            cg_iters=cg_iters, group=group)
