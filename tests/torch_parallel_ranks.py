"""The rank worker of tests/test_torch_parallel.py: what each gloo rank of a
spawned group runs. It imports torch and the port only, never jax or the
JAX package, since every rank is a fresh interpreter of the port alone; the
test holds the results against JAX in its own process.

`rank_checks(rank, world, work_dir)` reads the problems the test wrote to
work_dir/problems.npz and writes this rank's results to
work_dir/rank<r>.pt: the sharded global BA and essential graph, at 4 ranks
the dp x sp front-end step on a tracked state of its rows
(multiseq.tracked_args), at 2 ranks the dry run and the solvers with
group=None against a group of one rank.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from orb_slam_system_tpu_torch.parallel import multiseq
from orb_slam_system_tpu_torch.parallel.ba_dist import bundle_adjust_cg_sharded
from orb_slam_system_tpu_torch.parallel.pose_graph_dist import (
    optimize_essential_graph_sharded)
from orb_slam_system_tpu_torch.solvers.local_ba import (BAProblem,
                                                        bundle_adjust_cg)
from orb_slam_system_tpu_torch.solvers.pose_graph import (
    optimize_essential_graph)
from orb_slam_system_tpu_torch.solvers.pose_opt import (
    pose_optimization, pose_optimization_batch)

BA_ITERS, BA_CG = 4, 25     # tests/test_pose_graph_dist.py's schedules
EG_ITERS, EG_CG = 15, 40
MESH_SHAPE = (96, 128, 128, 2)   # height, width, features, levels


def ba_problem(z) -> BAProblem:
    t = {k: torch.from_numpy(z["ba_" + k]) for k in (
        "Tcw", "cam_fixed", "cam_valid", "points", "pt_valid", "e_cam",
        "e_pt", "e_uv", "e_inv_sigma2", "e_valid")}
    return BAProblem(**t)


def eg_args(z):
    return [torch.from_numpy(z["eg_" + k]) for k in (
        "R0", "t0", "s0", "fixed", "valid", "e_i", "e_j", "e_R", "e_t", "e_s",
        "e_valid")]


def rank_checks(rank: int, world: int, work_dir: str) -> None:
    z = dict(np.load(os.path.join(work_dir, "problems.npz")))
    prob = ba_problem(z)
    fx, fy, cx, cy = (float(v) for v in z["ba_intrinsics"])
    out = {"jax_imported": "jax" in sys.modules
           or "orb_slam_system_tpu" in sys.modules}
    out["ba"] = bundle_adjust_cg_sharded(prob, fx, fy, cx, cy,
                                         n_iters=BA_ITERS, cg_iters=BA_CG)
    out["eg"] = optimize_essential_graph_sharded(
        *eg_args(z), n_iters=EG_ITERS, cg_iters=EG_CG)
    if world == 4:
        mesh = multiseq.make_mesh(world)
        h, w, nf, nl = MESH_SHAPE
        step, args = multiseq.make_multiseq_step(h, w, n_features=nf,
                                                 n_levels=nl, device="cpu",
                                                 mesh=mesh)
        T, n_in, n_match = step(*multiseq.tracked_args(args[0], nf, nl))
        out["mesh"] = dict(shape=mesh.shape, d=mesh.d, m=mesh.m, T=T,
                           n_in=int(n_in), n_match=int(n_match))
    if world == 2:
        out["dryrun"] = multiseq.dryrun(world)
        # group=None against a group of this rank alone, every solver.
        one = [dist.new_group([r]) for r in range(world)][rank]
        rng = np.random.default_rng(rank)
        T0 = torch.eye(4).repeat(2, 1, 1)
        X = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
        X[..., 2] += 4.0
        uv = X[..., :2] / X[..., 2:] * 100.0 + 64.0 + torch.from_numpy(
            rng.normal(0, 0.5, (2, 64, 2)).astype(np.float32))
        w = torch.ones(2, 64)
        ok = torch.ones(2, 64, dtype=torch.bool)
        pairs = {}
        for name, fn in (
                ("bundle_adjust_cg", lambda g: bundle_adjust_cg(
                    prob, fx, fy, cx, cy, n_iters=BA_ITERS, cg_iters=BA_CG,
                    group=g)),
                ("optimize_essential_graph",
                 lambda g: optimize_essential_graph(
                     *eg_args(z), n_iters=EG_ITERS, cg_iters=EG_CG, group=g)),
                ("pose_optimization", lambda g: pose_optimization(
                    T0[0], X[0], uv[0], w[0], ok[0], 100.0, 100.0, 64.0, 64.0,
                    group=g)),
                ("pose_optimization_batch", lambda g: pose_optimization_batch(
                    T0, X, uv, w, ok, 100.0, 100.0, 64.0, 64.0, group=g))):
            pairs[name] = (fn(None), fn(one))
        out["group_one"] = pairs
    torch.save(out, os.path.join(work_dir, f"rank{rank}.pt"))
