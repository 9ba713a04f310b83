"""The loop-closing solvers of the port against the JAX package on the CPU:
the Sim3 Lie functions, Horn's closed form, the batched Sim3 RANSAC,
OptimizeSim3, the essential graph and the CG bundle adjustment, on the same
numpy inputs made from a seed.

Tolerances, stated per test: Lie functions 1e-5; horn_sim3 s, R, t 1e-4;
RANSAC and OptimizeSim3 the same ok / inlier count / mask, s and t within
1e-3, R within 0.05 deg; essential graph poses 1e-3 / 0.05 deg;
bundle_adjust_cg 1e-4. Rotations are compared as matrices, never as
quaternions (an eigenvector's sign is arbitrary).

The Sim3 cases run with the scale free (monocular) and fixed (stereo and
RGB-D, fix_scale), where s must come out exactly 1. With the scale fixed
the data's true scale is 1, as a depth sensor's map has it: there the port
(Horn's translation at s = 1 in every hypothesis, as the reference) and the
JAX RANSAC (the free scale's translation, then s = 1) agree; at another
true scale they would not (ROADMAP.md section 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.solvers import local_ba as jba
from orb_slam_system_tpu.solvers import pose_graph as jpg
from orb_slam_system_tpu.solvers import sim3 as jsim3
from orb_slam_system_tpu.utils import lie as jlie
from orb_slam_system_tpu_torch.solvers import local_ba, pose_graph, sim3
from orb_slam_system_tpu_torch.utils import lie
from orb_slam_system_tpu_torch.utils.interop import ba_problem_from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0


def T(a):
    return torch.from_numpy(np.array(a))


def rot_deg(Ra, Rb):
    M = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.degrees(np.arctan2(0.5 * s, 0.5 * (np.trace(M) - 1.0))))


def test_lie_functions_match_jax(rng):
    """so3_log (positive trace), se3_log, the left Jacobian, se3_apply,
    rot_from_quat and the Sim3 functions on a batch, 1e-5."""
    xi = (rng.normal(size=(16, 7)) * [0.5, 0.5, 0.5, 0.6, 0.6, 0.6, 0.3]
          ).astype(np.float32)
    xi[0, 3:7] = 0.0                                    # the zero-angle branches
    xi[1, 6] = 0.0
    X = rng.normal(size=(5, 3)).astype(np.float32)
    S = lie.sim3_exp(T(xi))
    S2 = lie.sim3_exp(T(xi[::-1].copy()))
    for i in range(len(xi)):
        jS = jlie.sim3_exp(jnp.asarray(xi[i]))
        jS2 = jlie.sim3_exp(jnp.asarray(xi[::-1][i]))
        one = {k: v[i] for k, v in S.items()}
        for k in "Rts":
            np.testing.assert_allclose(one[k].numpy(), np.asarray(jS[k]), atol=1e-5)
        np.testing.assert_allclose(lie.sim3_log(one).numpy(),
                                   np.asarray(jlie.sim3_log(jS)), atol=1e-5)
        mul = lie.sim3_mul(one, {k: v[i] for k, v in S2.items()})
        jmul = jlie.sim3_mul(jS, jS2)
        inv = lie.sim3_inv(one)
        jinv = jlie.sim3_inv(jS)
        for k in "Rts":
            np.testing.assert_allclose(mul[k].numpy(), np.asarray(jmul[k]), atol=1e-5)
            np.testing.assert_allclose(inv[k].numpy(), np.asarray(jinv[k]), atol=1e-5)
        np.testing.assert_allclose(lie.sim3_apply(one, T(X)).numpy(),
                                   np.asarray(jlie.sim3_apply(jS, jnp.asarray(X))),
                                   atol=1e-5)
        w = xi[i, 3:6]
        R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
        assert np.trace(R) > 0
        np.testing.assert_allclose(lie.so3_log(T(R)).numpy(),
                                   np.asarray(jlie.so3_log(jnp.asarray(R))), atol=1e-5)
        np.testing.assert_allclose(lie._so3_left_jacobian(T(w)).numpy(),
                                   np.asarray(jlie._so3_left_jacobian(jnp.asarray(w))),
                                   atol=1e-5)
        Tm = np.asarray(jlie.se3_exp(jnp.asarray(xi[i, :6])))
        np.testing.assert_allclose(lie.se3_log(T(Tm)).numpy(),
                                   np.asarray(jlie.se3_log(jnp.asarray(Tm))), atol=1e-5)
        np.testing.assert_allclose(lie.se3_apply(T(Tm), T(X)).numpy(),
                                   np.asarray(jlie.se3_apply(jnp.asarray(Tm),
                                                             jnp.asarray(X))), atol=1e-5)
        q = rng.normal(size=4).astype(np.float32)
        np.testing.assert_allclose(lie.rot_from_quat(T(q)).numpy(),
                                   np.asarray(jlie.rot_from_quat(jnp.asarray(q))), atol=1e-5)
    # Batched calls equal the per-element ones.
    np.testing.assert_allclose(lie.sim3_log(S).numpy(), xi, atol=1e-5)


def test_so3_log_non_positive_trace():
    """Where the trace is not positive the port takes the largest diagonal
    entry's quaternion case (the JAX version's case is one off there). At a
    rotation of 3.0 rad about an axis near x the port's log is held against
    the exact angle-axis, 1e-5."""
    axis = np.array([0.9, 0.3, -0.2])
    axis /= np.linalg.norm(axis)
    w = (3.0 * axis).astype(np.float32)
    R = lie.so3_exp(T(w))
    assert float(torch.diagonal(R).sum()) <= 0
    np.testing.assert_allclose(lie.so3_log(R).numpy(), w, atol=1e-5)


def _sim3_setup(rng, N=64, n_out=16, s=1.3, t=(0.4, -0.2, 0.3)):
    """tests/test_sim3_posegraph.py::test_sim3_ransac_with_outliers's setup."""
    P2 = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    P2[:, 2] = rng.uniform(4, 8, size=N)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.1, jnp.float32)))
    P1 = s * (P2 @ R.T) + np.asarray(t, np.float32)
    uv1 = ((P1[:, :2] / P1[:, 2:3]) * [FX, FY] + [CX, CY]).astype(np.float32)
    uv2 = ((P2[:, :2] / P2[:, 2:3]) * [FX, FY] + [CX, CY]).astype(np.float32)
    idx = rng.choice(N, size=n_out, replace=False)
    P2o = P2.copy()
    P2o[idx] = P2o[idx][::-1] + rng.normal(size=(n_out, 3))
    return P1.astype(np.float32), P2o.astype(np.float32), uv1, uv2, R


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_matches_jax(rng, fix_scale):
    P1, P2, _, _, _ = _sim3_setup(rng, n_out=0)
    w = (rng.uniform(size=len(P1)) > 0.3).astype(np.float32)
    s, R, t = sim3.horn_sim3(T(P1), T(P2), T(w), fix_scale)
    js, jR, jt = jsim3.horn_sim3(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(w),
                                 fix_scale)
    assert abs(float(s) - float(js)) < 1e-4
    if fix_scale:
        assert float(s) == 1.0
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
@pytest.mark.parametrize("n_cand", [1, 3])
def test_sim3_ransac_batch_matches_jax(rng, n_cand, fix_scale):
    """The same sample sets, drawn over the JAX loop closer's padded bound,
    on 1 and 3 candidate pairs (the last with 10 invalid slots)."""
    setups = [_sim3_setup(rng, s=1.0 if fix_scale else 1.3 + 0.2 * c)
              for c in range(n_cand)]
    P1, P2, uv1, uv2 = (np.stack([s_[k] for s_ in setups]) for k in range(4))
    N = P1.shape[1]
    valid = np.ones((n_cand, N), bool)
    valid[-1, -10:] = False
    m = np.full((n_cand, N), 9.21, np.float32)
    sets = jsim3.make_sim3_sample_sets(64, 300, 0)
    assert np.array_equal(sim3.make_sim3_sample_sets(64, 300, 0), sets)
    got = sim3.sim3_ransac_batch(T(P1), T(P2), T(uv1), T(uv2), T(m), T(m),
                                 T(valid), T(sets.astype(np.int64)),
                                 FX, FY, CX, CY, fix_scale=fix_scale).numpy()
    want = np.asarray(jsim3.sim3_ransac_batch(
        *(jnp.asarray(a) for a in (P1, P2, uv1, uv2, m, m, valid, sets)),
        FX, FY, CX, CY, fix_scale=fix_scale))
    assert got.shape == want.shape == (n_cand, 14 + N)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert got[:, 0].all()
    np.testing.assert_array_equal(got[:, 14:], want[:, 14:])
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-3)
    np.testing.assert_allclose(got[:, 11:14], want[:, 11:14], atol=1e-3)
    if fix_scale:
        assert (got[:, 1] == 1.0).all()
    for c in range(n_cand):
        assert rot_deg(got[c, 2:11].reshape(3, 3), want[c, 2:11].reshape(3, 3)) < 0.05
        assert rot_deg(got[c, 2:11].reshape(3, 3), setups[c][4]) < 0.3


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(rng, fix_scale):
    """tests/test_sim3_posegraph.py::test_optimize_sim3_refines's setup,
    with 6 outlier rows so stage 2 drops edges. With the scale fixed the
    data's scale and the start's are 1, as the loop closer hands it a
    fixed-scale RANSAC result, and s stays exactly 1."""
    N = 48
    s_true = 1.0 if fix_scale else 0.8
    P1, P2, uv1, uv2, R = _sim3_setup(rng, N=N, n_out=6, s=s_true,
                                      t=(0.3, 0.1, -0.2))
    dxi = np.concatenate([rng.normal(size=6) * 0.02,
                          [0.0 if fix_scale else 0.05]]).astype(np.float32)
    S0 = jlie.sim3_mul(jlie.sim3_exp(jnp.asarray(dxi)),
                       {"R": jnp.asarray(R), "t": jnp.asarray([0.3, 0.1, -0.2], jnp.float32),
                        "s": jnp.asarray(s_true, jnp.float32)})
    s0, R0, t0 = (np.asarray(S0[k], np.float32) for k in "sRt")
    is2 = np.ones(N, np.float32)
    valid = np.ones(N, bool)
    jn, js, jR, jt, jinl = jpg.optimize_sim3(
        jnp.asarray(s0), jnp.asarray(R0), jnp.asarray(t0),
        *(jnp.asarray(a) for a in (P1, P2, uv1, uv2, is2, is2, valid)),
        FX, FY, CX, CY, fix_scale=fix_scale)
    n, s, Rr, t, inl = pose_graph.optimize_sim3(
        T(s0), T(R0), T(t0), *(T(a) for a in (P1, P2, uv1, uv2, is2, is2, valid)),
        FX, FY, CX, CY, fix_scale=fix_scale)
    assert int(n) == int(jn) >= N - 6
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert abs(float(s) - float(js)) < 1e-3
    if fix_scale:
        assert float(s) == float(js) == 1.0
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-3)
    assert rot_deg(Rr.numpy(), np.asarray(jR)) < 0.05


def _drift_graph(rng, K=12):
    """tests/test_sim3_posegraph.py::test_essential_graph_corrects_drift's
    graph: a drifted circle of K keyframes, odometry edges from the drifted
    poses, one loop edge K-1 -> 0 from the truth."""
    def make_pose(k):
        ang = 2 * np.pi * k / K
        xi = np.array([0.5 * np.sin(ang), 0.0, 0.5 * (1 - np.cos(ang)),
                       0.0, ang, 0.0], np.float32)
        return np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    T_true = [make_pose(k) for k in range(K)]
    T_est = [T_true[0]]
    for k in range(1, K):
        rel = T_true[k] @ np.linalg.inv(T_true[k - 1])
        noise = np.asarray(jlie.se3_exp(jnp.asarray(
            (rng.normal(size=6) * 0.02).astype(np.float32))))
        T_est.append(noise @ rel @ T_est[-1])
    edges = [(k, k + 1, T_est[k], T_est[k + 1]) for k in range(K - 1)]
    edges.append((K - 1, 0, T_true[K - 1], T_true[0]))
    rel = [Tj @ np.linalg.inv(Ti) for _, _, Ti, Tj in edges]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    args = (np.stack([T_[:3, :3] for T_ in T_est]).astype(np.float32),
            np.stack([T_[:3, 3] for T_ in T_est]).astype(np.float32),
            np.ones(K, np.float32), fixed, np.ones(K, bool),
            np.asarray([e[0] for e in edges], np.int32),
            np.asarray([e[1] for e in edges], np.int32),
            np.stack([r[:3, :3] for r in rel]).astype(np.float32),
            np.stack([r[:3, 3] for r in rel]).astype(np.float32),
            np.ones(len(edges), np.float32), np.ones(len(edges), bool))
    return args, T_true


def test_essential_graph_matches_jax(rng):
    K = 12
    args, T_true = _drift_graph(rng, K)
    jR, jt, js = (np.asarray(a) for a in jpg.optimize_essential_graph(
        *(jnp.asarray(a) for a in args), n_iters=20, cg_iters=40))
    targs = [T(a.astype(np.int64) if a.dtype == np.int32 else a) for a in args]
    R, t, s = (a.numpy() for a in pose_graph.optimize_essential_graph(
        *targs, n_iters=20, cg_iters=40))
    np.testing.assert_allclose(t, jt, atol=1e-3)
    np.testing.assert_allclose(s, js, atol=1e-3)
    assert max(rot_deg(R[k], jR[k]) for k in range(K)) < 0.05

    def loop_err(R_all, t_all):
        Tl, Tf = np.eye(4), np.eye(4)
        Tl[:3, :3], Tl[:3, 3] = R_all[K - 1], t_all[K - 1]
        Tf[:3, :3], Tf[:3, 3] = R_all[0], t_all[0]
        return np.abs(Tl @ np.linalg.inv(Tf)
                      - T_true[K - 1] @ np.linalg.inv(T_true[0])).max()
    before = loop_err(args[0], args[1])
    assert loop_err(R, t) < 0.3 * before and loop_err(jR, jt) < 0.3 * before
    np.testing.assert_allclose(R[0], args[0][0], atol=1e-6)


def _ba_problem(rng, n_cams=4, n_pts=48):
    """A seeded problem in the shape of tests/test_local_ba.make_problem:
    cameras on a baseline, noisy observations, perturbed start, camera 0
    fixed, one invalid point and a few invalid edges."""
    X_true = rng.uniform(-3, 3, size=(n_pts, 3)).astype(np.float32)
    X_true[:, 2] = rng.uniform(5, 9, size=n_pts)
    Tcws = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(
        np.array([0.3 * c, 0, 0, 0, 0.01 * c, 0], np.float32))))
        for c in range(n_cams)])
    e_cam, e_pt, e_uv = [], [], []
    for c in range(n_cams):
        Xc = X_true @ Tcws[c][:3, :3].T + Tcws[c][:3, 3]
        uv = (Xc[:, :2] / Xc[:, 2:3]) * [FX, FY] + [CX, CY]
        uv += rng.normal(size=uv.shape) * 0.3
        e_cam += [c] * n_pts
        e_pt += list(range(n_pts))
        e_uv += list(uv)
    E = len(e_cam)
    Tcw0 = Tcws.copy()
    for c in range(1, n_cams):
        Tcw0[c] = np.asarray(jlie.se3_exp(jnp.asarray(
            (rng.normal(size=6) * 0.02).astype(np.float32)))) @ Tcws[c]
    pt_valid = np.ones(n_pts, bool)
    pt_valid[3] = False
    e_valid = np.ones(E, bool)
    e_valid[rng.choice(E, 5, replace=False)] = False
    return jba.BAProblem(
        Tcw=jnp.asarray(Tcw0.astype(np.float32)),
        cam_fixed=jnp.asarray(np.arange(n_cams) == 0),
        cam_valid=jnp.asarray(np.ones(n_cams, bool)),
        points=jnp.asarray(X_true + rng.normal(size=X_true.shape).astype(np.float32) * 0.05),
        pt_valid=jnp.asarray(pt_valid), e_cam=jnp.asarray(np.asarray(e_cam, np.int32)),
        e_pt=jnp.asarray(np.asarray(e_pt, np.int32)),
        e_uv=jnp.asarray(np.asarray(e_uv, np.float32)),
        e_inv_sigma2=jnp.asarray(rng.uniform(0.5, 1.0, E).astype(np.float32)),
        e_valid=jnp.asarray(e_valid))


def test_bundle_adjust_cg_matches_jax(rng):
    prob = _ba_problem(rng)
    jT, jX = jba.bundle_adjust_cg(prob, FX, FY, CX, CY, n_iters=4, cg_iters=30)
    Tn, X = local_ba.bundle_adjust_cg(ba_problem_from_numpy(prob, "cpu"),
                                      FX, FY, CX, CY, n_iters=4, cg_iters=30)
    np.testing.assert_allclose(Tn.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), atol=1e-4)
    assert not np.allclose(Tn.numpy(), np.asarray(prob.Tcw), atol=1e-4)
