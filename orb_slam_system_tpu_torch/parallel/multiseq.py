"""The batched multi-sequence front-end step on one card.

Port of orb_slam_system_tpu/parallel/multiseq.py's `make_multiseq_step`
(the JAX package's `local_step`, :69-111): for S sequences at once,
extraction at batch S, all-pairs Hamming matching against each sequence's
previous descriptors, and a motion-only pose LM per sequence, batched
(solvers/pose_opt.pose_optimization_batch), then the inlier and match
totals over all sequences.

The JAX step shards this over a ('data', 'model') device mesh: sequences
over 'data', the query keypoint rows over 'model', with the pose LM's
normal equations and the totals psum'd across shards. On one device both
splits are the whole computation (the JAX test
test_multiseq_sharded_equals_single_device shows the sharded step equals
the single-device one), so there is no mesh here. The Hamming matrix
comes from ops/hamming.distance_matrix (the JAX int8 +-1 form is the
TPU's matrix-unit layout). `dryrun` and the sharded solvers it drives are
not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import ORBConfig
from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
from orb_slam_system_tpu_torch.ops.hamming import distance_matrix
from orb_slam_system_tpu_torch.solvers.pose_opt import pose_optimization_batch
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy

MATCH_TH = 50        # JAX local_step's Hamming gate
_FAR = 1 << 20       # distance of a masked pair


def make_multiseq_step(height: int, width: int, n_features: int = 256,
                       n_levels: int = 4, n_sequences: int = 2,
                       device="cuda"):
    """Returns (step, example_args) on `device`:

    step(imgs u8/f32[S,H,W], prev_desc i32[S,N,8] (u32 bit patterns; numpy
    u32 is taken as is), prev_valid bool[S,N], pts f32[S,N,3],
    Tcw0 f32[S,4,4]) -> (Tcw f32[S,4,4], n_inliers, n_matched), the totals
    0-dim int64 tensors. Nothing in it reads back to the host.
    example_args are the JAX step's example arguments for S = n_sequences
    (the same draws of default_rng(0) in the same order), as tensors on
    `device`."""
    set_f32_policy()
    dev = torch.device(device)
    extractor = ORBExtractor(ORBConfig(n_features=n_features,
                                       n_levels=n_levels), height, width)
    N = extractor.n_slots
    fx = fy = 0.8 * width
    cx, cy = width / 2.0, height / 2.0

    def put(a):
        if isinstance(a, np.ndarray) and a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(a).to(dev)

    def step(imgs, prev_desc, prev_valid, pts, Tcw0):
        """One front-end step of all S sequences (the JAX local_step)."""
        imgs, prev_desc, prev_valid, pts, Tcw0 = map(
            put, (imgs, prev_desc, prev_valid, pts, Tcw0))
        feats = extractor(imgs.to(torch.float32).contiguous())
        dist = distance_matrix(feats.desc, prev_desc)          # [S, N, N]
        mask = feats.valid[:, :, None] & prev_valid[:, None, :]
        dist = torch.where(mask, dist, torch.full_like(dist, _FAR))
        best_j = dist.argmin(dim=2)                            # first minimum
        best = dist.gather(2, best_j[..., None])[..., 0]
        matched = best <= MATCH_TH
        X = pts.gather(1, best_j[..., None].expand(-1, -1, 3))
        T, _, n_in = pose_optimization_batch(
            Tcw0, X, feats.xy, torch.ones_like(best, dtype=torch.float32),
            matched, fx, fy, cx, cy)
        return T, n_in.sum(), matched.sum()

    # The JAX step's example arguments, draw for draw, for S sequences.
    S = n_sequences
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, size=(S, height, width)).astype(np.float32)
    prev_desc = rng.integers(0, 2 ** 32, size=(S, N, 8), dtype=np.uint32)
    prev_valid = np.ones((S, N), bool)
    pts = rng.uniform(-2, 2, size=(S, N, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(3, 8, size=(S, N))
    Tcw0 = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    return step, tuple(map(put, (imgs, prev_desc, prev_valid, pts, Tcw0)))
