"""The batched multi-sequence front-end step, on one card or sharded over
ranks, and the dry run of the three sharded programs.

Port of orb_slam_system_tpu/parallel/multiseq.py. `make_multiseq_step`
(the JAX package's `local_step`, :69-111): for S sequences at once,
extraction at batch S, all-pairs Hamming matching against each sequence's
previous descriptors, and a motion-only pose LM per sequence, batched
(solvers/pose_opt.pose_optimization_batch), then the inlier and match
totals over all sequences. The Hamming matrix comes from
ops/hamming.distance_matrix (the JAX int8 +-1 form is the TPU's
matrix-unit layout).

The JAX step shards this over a ('data', 'model') device mesh with
`shard_map`. Here the mesh is a grid of torch.distributed ranks
(`make_mesh`, rank = d * mp + m): the sequences split over 'data', the
query keypoint rows over 'model'; the pose LM's normal equations and costs
are summed over the rank's 'model' group and the totals over 'model' and
'data' (JAX :92-109). `tracked_args` makes a state the step has edges to
solve on. `dryrun` runs the step, the sharded essential graph and the
sharded global BA on the group that is up, and `dryrun_multichip` starts
the ranks for it (the JAX __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from orb_slam_system_tpu_torch.config import ORBConfig
from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
from orb_slam_system_tpu_torch.ops.hamming import distance_matrix
from orb_slam_system_tpu_torch.solvers.pose_opt import pose_optimization_batch
from orb_slam_system_tpu_torch.utils.collectives import all_sum, require_group
from orb_slam_system_tpu_torch.utils.metrics import span
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy

MATCH_TH = 50        # JAX local_step's Hamming gate
_FAR = 1 << 20       # distance of a masked pair
SEQS_PER_DATA = 2    # sequences per 'data' index (JAX :128)
TRACKED_OFFSET = (0.02, -0.01, 0.01)   # tracked_args' camera offset, m


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the dp x mp grid and its two groups: `data_group`
    (the ranks of its column, same m) and `model_group` (its row, same d)."""
    dp: int
    mp: int
    d: int
    m: int
    data_group: object
    model_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.mp}


def make_mesh(n_devices: int, model_parallel: int = 2) -> Mesh:
    """The ('data', 'model') grid over the n_devices ranks of the default
    group (JAX :37-43): mp = model_parallel when it divides n_devices, else
    1. Every rank makes every group, in the same order."""
    require_group()
    if dist.get_world_size() != n_devices:
        raise ValueError(f"a mesh of {n_devices} on a group of "
                         f"{dist.get_world_size()} ranks")
    mp = model_parallel if n_devices % model_parallel == 0 else 1
    dp = n_devices // mp
    d, m = divmod(dist.get_rank(), mp)
    data_groups = [dist.new_group([dd * mp + mm for dd in range(dp)])
                   for mm in range(mp)]
    model_groups = [dist.new_group([dd * mp + mm for mm in range(mp)])
                    for dd in range(dp)]
    return Mesh(dp, mp, d, m, data_groups[m], model_groups[d])


def make_multiseq_step(height: int, width: int, n_features: int = 256,
                       n_levels: int = 4, n_sequences: int = 2,
                       device="cuda", mesh: Mesh = None):
    """Returns (step, example_args) on `device`:

    step(imgs u8/f32[S,H,W], prev_desc i32[S,N,8] (u32 bit patterns; numpy
    u32 is taken as is), prev_valid bool[S,N], pts f32[S,N,3],
    Tcw0 f32[S,4,4]) -> (Tcw f32[S,4,4], n_inliers, n_matched), the totals
    0-dim int64 tensors. Nothing in it reads back to the host.
    example_args are the JAX step's example arguments for S = n_sequences
    (the same draws of default_rng(0) in the same order), as tensors on
    `device`.

    With a mesh, S = 2 x data (n_sequences is not used): this rank takes
    sequences [2d, 2d + 2) and query rows [m N / mp, (m + 1) N / mp); its
    step takes and returns its own 2 sequences, the totals are global, and
    example_args are this rank's rows of the full draw."""
    set_f32_policy()
    dev = torch.device(device)
    extractor = ORBExtractor(ORBConfig(n_features=n_features,
                                       n_levels=n_levels), height, width)
    N = extractor.n_slots
    fx = fy = 0.8 * width
    cx, cy = width / 2.0, height / 2.0
    if mesh is not None:
        # A remainder of rows would belong to no rank, and its matches
        # would vanish from the totals (JAX :60-64).
        assert N % mesh.mp == 0, (
            f"n_slots {N} not divisible by model axis {mesh.mp}")
    nq = N if mesh is None else N // mesh.mp
    q0 = 0 if mesh is None else mesh.m * nq
    lm_group = None if mesh is None else mesh.model_group

    def put(a):
        if isinstance(a, np.ndarray) and a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(a).to(dev)

    def step(imgs, prev_desc, prev_valid, pts, Tcw0):
        """One front-end step of the sequences (the JAX local_step)."""
        imgs, prev_desc, prev_valid, pts, Tcw0 = map(
            put, (imgs, prev_desc, prev_valid, pts, Tcw0))
        feats = extractor(imgs.to(torch.float32).contiguous())
        desc, valid, xy = (feats.desc, feats.valid, feats.xy)
        if mesh is not None:
            desc, valid, xy = (t[:, q0:q0 + nq] for t in (desc, valid, xy))
        dist_m = distance_matrix(desc, prev_desc)              # [S, nq, N]
        mask = valid[:, :, None] & prev_valid[:, None, :]
        dist_m = torch.where(mask, dist_m, torch.full_like(dist_m, _FAR))
        best_j = dist_m.argmin(dim=2)                          # first minimum
        best = dist_m.gather(2, best_j[..., None])[..., 0]
        matched = best <= MATCH_TH
        X = pts.gather(1, best_j[..., None].expand(-1, -1, 3))
        with span("track.pose_lm"):
            T, _, n_in = pose_optimization_batch(
                Tcw0, X, xy, torch.ones_like(best, dtype=torch.float32),
                matched, fx, fy, cx, cy, group=lm_group)
        n_in, n_match = n_in.sum(), matched.sum()
        if mesh is not None:
            n_in = all_sum(all_sum(n_in, mesh.model_group), mesh.data_group)
            n_match = all_sum(all_sum(n_match, mesh.data_group),
                              mesh.model_group)
        return T, n_in, n_match

    # The JAX step's example arguments, draw for draw, for S sequences.
    S = n_sequences if mesh is None else SEQS_PER_DATA * mesh.dp
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, size=(S, height, width)).astype(np.float32)
    prev_desc = rng.integers(0, 2 ** 32, size=(S, N, 8), dtype=np.uint32)
    prev_valid = np.ones((S, N), bool)
    pts = rng.uniform(-2, 2, size=(S, N, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(3, 8, size=(S, N))
    Tcw0 = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    rows = (slice(None) if mesh is None else
            slice(SEQS_PER_DATA * mesh.d, SEQS_PER_DATA * (mesh.d + 1)))
    return step, tuple(put(a[rows])
                       for a in (imgs, prev_desc, prev_valid, pts, Tcw0))


def tracked_args(imgs: torch.Tensor, n_features: int, n_levels: int):
    """A tracked state for the step on images imgs u8/f32[S,H,W] (on the
    step's device): (imgs, prev_desc, prev_valid, pts, Tcw0) with prev_desc
    the images' own descriptors with one bit of each flipped, prev_valid
    their valid slots, pts the keypoints back-projected at depths in
    [3, 8) m from a camera TRACKED_OFFSET m off the origin, and Tcw0 the
    identity. The points are jittered by up to 1 cm and every tenth is
    an outlier. The step matches every valid keypoint to its own slot and
    its LM moves each pose near TRACKED_OFFSET. Nothing is drawn, so a
    rank's rows of the state are the state of its rows."""
    S, H, W = imgs.shape
    dev = imgs.device
    feats = ORBExtractor(ORBConfig(n_features=n_features, n_levels=n_levels),
                         H, W)(imgs.to(torch.float32).contiguous())
    N = feats.desc.shape[1]
    slot = torch.arange(N, device=dev)
    flip = torch.where(slot[:, None] % 8 == torch.arange(8, device=dev),
                       torch.bitwise_left_shift(torch.ones_like(slot),
                                                slot % 31)[:, None],
                       torch.zeros_like(slot)[:, None]).to(torch.int32)
    prev_desc = torch.bitwise_xor(feats.desc, flip)
    z = 3.0 + 5.0 * torch.frac(slot.to(torch.float32) * 0.6180339887)
    f, c = 0.8 * W, torch.tensor([W / 2.0, H / 2.0], device=dev)
    Xc = torch.cat([(feats.xy - c) / f * z[:, None], z[None, :, None].expand(
        S, N, 1)], dim=-1)
    # Points off their rays by up to 1 cm, and every tenth 0.5 m off (an
    # outlier), so each edge block alone would solve to another pose.
    jitter = 0.02 * (torch.frac(slot[:, None] * torch.tensor(
        [0.7548776662, 0.5698402910, 0.3247179572], device=dev)) - 0.5)
    jitter = jitter + 0.5 * (slot % 10 == 0)[:, None]
    pts = Xc + jitter - torch.tensor(TRACKED_OFFSET, device=dev)
    Tcw0 = torch.eye(4, device=dev).repeat(S, 1, 1)
    return imgs, prev_desc, feats.valid, pts, Tcw0


def dryrun(n_devices: int, height: int = 96, width: int = 128):
    """JAX multiseq.dryrun's four checks on the process group that is up
    (n_devices ranks), each rank on its card under NCCL, else on the CPU;
    raises on a failure:
    1. the dp x sp front-end step (128 features, 2 levels) on a tracked
       state of the JAX example's images: poses finite and within 1 cm of
       the state's offset, at least 80% of the matches inliers;
    2. the sharded essential graph on 6 vertices, finite;
    3. the sharded global BA on 4 cameras x 24 points, finite;
    4. on rank 0 only (the JAX controller runs it once), a 2-System
       MultiSystem over 10 frames at 320x240, both OK at the end.
    Returns the step's global (n_inliers, n_matched)."""
    from orb_slam_system_tpu_torch.parallel.ba_dist import (
        bundle_adjust_cg_sharded)
    from orb_slam_system_tpu_torch.parallel.pose_graph_dist import (
        optimize_essential_graph_sharded)
    from orb_slam_system_tpu_torch.solvers.local_ba import BAProblem

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    mesh = make_mesh(n_devices)
    step, args = make_multiseq_step(height, width, n_features=128,
                                    n_levels=2, device=dev, mesh=mesh)
    # On the JAX example's images, a tracked state (tracked_args): the
    # example's random descriptors match nothing, which leaves the LM no
    # edge and its sums nothing to check.
    T, n_in, n_match = step(*tracked_args(args[0], 128, 2))
    off = torch.tensor(TRACKED_OFFSET, device=dev)
    assert bool(torch.isfinite(T).all()), "the sharded step's poses"
    assert int(n_in) >= 0.8 * int(n_match) > 0, (
        f"the sharded step: {int(n_in)} inliers of {int(n_match)} matches")
    assert float((T[:, :3, 3] - off).abs().max()) < 0.01, (
        f"the sharded step's translations {T[:, :3, 3].tolist()}")

    def put(a):
        return torch.as_tensor(a).to(dev)
    K = 6
    rng = np.random.default_rng(0)
    R0 = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t0 = rng.normal(size=(K, 3)).astype(np.float32) * 0.1
    s0 = np.ones(K, np.float32)
    e_i = np.arange(K - 1, dtype=np.int64)
    fixed = np.arange(K) == 0
    _, tn, _ = optimize_essential_graph_sharded(
        *map(put, (R0, t0, s0, fixed, np.ones(K, bool), e_i, e_i + 1,
                   np.tile(np.eye(3, dtype=np.float32), (K - 1, 1, 1)),
                   np.zeros((K - 1, 3), np.float32),
                   np.ones(K - 1, np.float32), np.ones(K - 1, bool))),
        n_iters=3, cg_iters=10)
    assert bool(torch.isfinite(tn).all()), "the sharded essential graph"

    C, P = 4, 24
    world = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32)
    world[:, 2] += 4.0
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    Tcw[:, 0, 3] = -0.1 * np.arange(C)
    f = 100.0
    Xc = [world @ Tcw[c, :3, :3].T + Tcw[c, :3, 3] for c in range(C)]
    uv = np.concatenate([x[:, :2] / x[:, 2:3] * f + 64.0
                         for x in Xc]).astype(np.float32)
    E = C * P
    prob = BAProblem(
        Tcw=put(Tcw), cam_fixed=put(np.arange(C) == 0),
        cam_valid=put(np.ones(C, bool)), points=put(world + 0.01),
        pt_valid=put(np.ones(P, bool)),
        e_cam=put(np.repeat(np.arange(C), P)),
        e_pt=put(np.tile(np.arange(P), C)),
        e_uv=put(uv), e_inv_sigma2=put(np.ones(E, np.float32)),
        e_valid=put(np.ones(E, bool)))
    _, Xn = bundle_adjust_cg_sharded(prob, f, f, 64.0, 64.0, n_iters=2,
                                     cg_iters=8)
    assert bool(torch.isfinite(Xn).all()), "the sharded global BA"

    if dist.get_rank() == 0:
        _two_systems(dev)
    dist.barrier()
    return int(n_in), int(n_match)


def _two_systems(dev) -> None:
    """The full-system check of JAX dryrun: two complete Systems on one
    batched extraction over 10 frames at 320x240, both OK at the end."""
    from orb_slam_system_tpu_torch.config import (CameraConfig, Sensor,
                                                  SlamConfig, TrackingState)
    from orb_slam_system_tpu_torch.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu_torch.parallel.multi_system import MultiSystem

    W, H = 320, 240
    cam = CameraConfig(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=400),
                     sensor=Sensor.MONOCULAR)
    rends = [PlanarSceneRenderer(cam.K, W, H,
                                 texture=make_texture(1024, 8, seed=7 + s),
                                 tex_scale=220.0) for s in range(2)]
    trajs = [orbit_trajectory(10, radius=0.3 + 0.02 * s, depth=-2.0,
                              tilt=0.3) for s in range(2)]
    msys = MultiSystem(cfg, 2, device=dev)
    for i in range(10):
        msys.track_batch(np.stack([rends[s].render(trajs[s][i])
                                   for s in range(2)]), i / 30.0)
    states = [s.get_tracking_state() for s in msys.systems]
    msys.shutdown()
    assert all(st == TrackingState.OK for st in states), states


def _dryrun_rank(rank: int, world: int, height: int, width: int) -> None:
    n_in, n_match = dryrun(world, height, width)
    if rank == 0:
        print(f"dryrun_multichip OK: {world} ranks "
              f"({dist.get_backend()}), n_inliers {n_in}, n_matched "
              f"{n_match}", flush=True)


def dryrun_multichip(n_devices: int, backend: str = "nccl",
                     height: int = 96, width: int = 128) -> None:
    """dryrun on n_devices fresh ranks (parallel/launch.spawn_ranks): NCCL
    with one rank per card, or gloo on the CPU when the caller asks for it,
    each rank on one torch thread. Any rank's failure fails the call."""
    from orb_slam_system_tpu_torch.parallel.launch import spawn_ranks
    spawn_ranks(_dryrun_rank, n_devices, backend, height, width)
