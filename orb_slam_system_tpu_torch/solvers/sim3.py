"""Sim3 solver: Horn's closed-form absolute orientation + batched RANSAC.

Port of orb_slam_system_tpu/solvers/sim3.py (reference Sim3Solver: Horn
1987 quaternion method, RANSAC over 3-point samples, inliers by mutual
reprojection under the chi2 9.210 sigma^2 gates). The scale is always free,
as the monocular System needs; the reference's fixed scale for stereo and
RGB-D comes back with those sensors.

Every hypothesis of every candidate pair is solved at once: the point
arguments carry a leading candidate axis [C, N] written out (the JAX
package vmaps a one-pair solver), the sample sets [S, 3] are shared, so one
call is a handful of batched ops over [C, S, N]. Float32 with TF32 off
(utils/precision). Where the JAX package's results depend on ties, the port
follows it: sample weights are SET by a scatter (a set drawing a slot
twice weighs it once), and the best hypothesis is the first maximum of the
inlier counts. The eigenvector of Horn's 4x4 matrix may come back with
either sign from LAPACK or cuSOLVER; R does not depend on it.
"""

from __future__ import annotations

import numpy as np
import torch

CHI2_SIM3 = 9.210  # reference Sim3Solver ctor :67-68
MIN_INLIERS = 20   # RANSAC(0.99, 20, 300), src/LoopClosing.cc:156


def horn_sim3(P1, P2, w):
    """Closed-form similarity P1 ~ s R P2 + t (frame-2 points into frame 1)
    weighted by w (0 excludes): P1, P2 [..., N, 3], w [..., N]. Returns
    (s [...], R [..., 3, 3], t [..., 3])."""
    wsum = w.sum(-1).clamp_min(1e-9)[..., None]
    mu1 = (P1 * w[..., None]).sum(-2) / wsum
    mu2 = (P2 * w[..., None]).sum(-2) / wsum
    Q1 = (P1 - mu1[..., None, :]) * w[..., None]
    Q2 = P2 - mu2[..., None, :]
    M = Q2.transpose(-1, -2) @ Q1     # sum over points of q2 q1^T
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    # Horn's N matrix, quaternion order [w, x, y, z].
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    q = torch.linalg.eigh(N)[1][..., -1]   # largest eigenvalue's vector
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)
    # Scale (reference :272-291, symmetric formulation).
    RQ2 = Q2 @ R.transpose(-1, -2)
    num = (Q1 * RQ2).sum((-1, -2))
    den = (Q2 * Q2 * w[..., None]).sum((-1, -2))
    s = num / den.clamp_min(1e-12)
    t = mu1 - s[..., None] * (R @ mu2[..., None])[..., 0]
    return s, R, t


def _project(P, fx, fy, cx, cy):
    z = P[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([fx * P[..., 0] / z + cx, fy * P[..., 1] / z + cy], -1)


def sim3_ransac_batch(P1, P2, uv1, uv2, max_err1, max_err2, valid,
                      sample_sets, fx, fy, cx, cy):
    """Sim3 RANSAC between the matched map points of C keyframe pairs.

    P1/P2: f32[C, N, 3] camera-frame points of KF1 / KF2; uv1/uv2 f32[C, N, 2]
    their observed pixels; max_err*: f32[C, N] 9.21 sigma^2 per point;
    valid: bool[C, N]; sample_sets: i64[S, 3], slots taken modulo each pair's
    valid count over its valid slots in order.

    Returns f32[C, 14 + N], per pair [ok, s, R (9), t (3), inliers (N)]: the
    similarity mapping KF2 camera points into KF1's frame (the JAX package's
    packed sim3_ransac_batch)."""
    C, N = valid.shape
    f32 = P1.dtype
    dev = P1.device
    slots = torch.arange(N, device=dev).expand(C, N)
    order = torch.argsort(torch.where(valid, slots, torch.full_like(slots, 1 << 28)),
                          dim=-1, stable=True)
    n_valid = valid.sum(-1).clamp_min(1)                            # [C]
    sel = order.gather(-1, (sample_sets.reshape(1, -1) % n_valid[:, None]))
    sel = sel.reshape(C, -1, 3)                                     # [C, S, 3]
    S = sel.shape[1]

    def ex(a, lead):
        # Broadcast a per-pair array over the set axis of [C, S] hypotheses.
        return a[:, None] if lead == 2 else a

    def check(s, R, t):
        # Mutual reprojection (reference CheckInliers :320) under hypotheses
        # with the leading axes [C] or [C, S].
        k = s.dim()
        P2in1 = (s[..., None, None] * (ex(P2, k) @ R.transpose(-1, -2))
                 + t[..., None, :])
        sinv = 1.0 / s.clamp_min(1e-12)
        P1in2 = sinv[..., None, None] * ((ex(P1, k) - t[..., None, :]) @ R)
        e1 = ex(uv1, k) - _project(P2in1, fx, fy, cx, cy)
        e2 = ex(uv2, k) - _project(P1in2, fx, fy, cx, cy)
        return (ex(valid, k) & ((e1 * e1).sum(-1) < ex(max_err1, k))
                & ((e2 * e2).sum(-1) < ex(max_err2, k)))

    def solve(w):
        k = w.dim() - 1
        return horn_sim3(ex(P1, k), ex(P2, k), w)

    # Per set: weight 1 on its (up to 3 distinct) slots, set not added.
    w = torch.zeros((C, S, N), dtype=f32, device=dev).scatter_(
        -1, sel, 1.0) * valid[:, None, :].to(f32)
    s_h, R_h, t_h = solve(w)
    inl_h = check(s_h, R_h, t_h)                                  # [C, S, N]
    good = (s_h > 1e-3) & (s_h < 1e3)     # reject negative / degenerate scales
    n_inl = torch.where(good, inl_h.sum(-1), torch.zeros_like(s_h, dtype=torch.int64))
    best = n_inl.argmax(-1)                                       # first maximum
    take = lambda a: a[torch.arange(C, device=dev), best]          # noqa: E731
    s_b, R_b, t_b = take(s_h), take(R_h), take(t_h)
    inliers = check(s_b, R_b, t_b)                                # [C, N]
    # Refine on the inliers; keep it if it holds at least as many.
    s_r, R_r, t_r = solve(inliers.to(f32))
    inl_r = check(s_r, R_r, t_r)
    use_r = inl_r.sum(-1) >= inliers.sum(-1)
    s_f = torch.where(use_r, s_r, s_b)
    R_f = torch.where(use_r[:, None, None], R_r, R_b)
    t_f = torch.where(use_r[:, None], t_r, t_b)
    inl_f = torch.where(use_r[:, None], inl_r, inliers)
    ok = inl_f.sum(-1) >= MIN_INLIERS
    return torch.cat([ok.to(f32)[:, None], s_f[:, None], R_f.reshape(C, 9),
                      t_f, inl_f.to(f32)], dim=1)


def make_sim3_sample_sets(n_slots: int, n_sets: int = 300, seed: int = 0):
    """Reference RANSAC(0.99, 20, 300) (src/LoopClosing.cc:156): the JAX
    package's draw of slots in [0, n_slots)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, max(n_slots, 1), size=(n_sets, 3)).astype(np.int32)
