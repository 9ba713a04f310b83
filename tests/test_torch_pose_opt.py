"""Port pose_optimization (4 rounds x 10 LM) against the JAX package on
the CPU: the same numpy edges into both. Tolerance: pose atol 1e-4 and
equal inlier masks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.solvers.pose_opt import pose_optimization as j_pose_opt
from orb_slam_system_tpu_torch.solvers.pose_opt import pose_optimization
from orb_slam_system_tpu_torch.utils.lie import se3_exp

FX = FY = 500.0
CX, CY = 320.0, 240.0
BF = 40.0


def _problem(rng, stereo: bool):
    N = 160
    X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                  rng.uniform(4, 10, N)], axis=1).astype(np.float32)
    T_true = se3_exp(torch.from_numpy(
        (rng.normal(size=6) * [0.2, 0.2, 0.2, 0.05, 0.05, 0.05]).astype(np.float32))).numpy()
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX,
                   FY * Xc[:, 1] / Xc[:, 2] + CY], axis=1)
    uv = (uv + rng.normal(size=uv.shape) * 0.5).astype(np.float32)
    out = rng.choice(N, size=20, replace=False)
    uv[out] += rng.uniform(20, 80, size=(20, 2)).astype(np.float32)
    ur = np.full(N, -1.0, np.float32)
    if stereo:
        st = rng.uniform(size=N) < 0.5
        ur[st] = (uv[st, 0] - BF / Xc[st, 2]
                  + rng.normal(size=st.sum()) * 0.5).astype(np.float32)
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, N))).astype(np.float32)
    valid = rng.uniform(size=N) < 0.95
    dxi = (rng.normal(size=6) * 0.03).astype(np.float32)
    T0 = (se3_exp(torch.from_numpy(dxi)).numpy() @ T_true).astype(np.float32)
    return T0, X, uv, inv_s2, valid, ur, T_true


@pytest.mark.parametrize("stereo", [False, True])
def test_pose_optimization_matches_jax(stereo, rng):
    T0, X, uv, inv_s2, valid, ur, T_true = _problem(rng, stereo)
    Tj, inl_j, n_j = j_pose_opt(jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv),
                                jnp.asarray(inv_s2), jnp.asarray(valid),
                                FX, FY, CX, CY, obs_ur=jnp.asarray(ur), bf=BF)
    t = torch.from_numpy
    Tp, inl_p, n_p = pose_optimization(t(T0), t(X), t(uv), t(inv_s2), t(valid),
                                       FX, FY, CX, CY, obs_ur=t(ur), bf=BF)
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl_p.numpy(), np.asarray(inl_j))
    assert int(n_p) == int(n_j)
    # And it actually solved the problem.
    np.testing.assert_allclose(Tp.numpy(), T_true, atol=2e-2)
