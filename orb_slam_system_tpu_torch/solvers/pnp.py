"""EPnP + RANSAC: absolute pose from 3D-2D correspondences.

Port of orb_slam_system_tpu/solvers/pnp.py (reference PnPsolver,
src/PnPsolver.cc): EPnP (Lepetit et al. 2009: 4 control points,
barycentric coordinates, the 12x12 null space, scale from the control
point distances) inside a RANSAC whose hypotheses are all evaluated at
once: every minimal set of every candidate is solved and scored in one
batched pass over leading [C, S] axes, the best set per candidate
(first maximum of the inlier count, as jnp.argmax) is refined by a
weighted EPnP on its inliers (reference Refine :209), and the refined pose
is kept when it explains at least as many points. Relocalization
(src/Tracking.cc:796-884) calls epnp_ransac_batch once for all its
candidates.

Float32 throughout, with TF32 off (utils/precision): the JAX code runs
under f32_solver. A sample set may repeat an index: its weight is set to
1 (a scatter, never an add), as the JAX package's `.at[idx].set(1.0)`.
Such a set leaves M^T M rank-deficient, where LAPACK and cuSOLVER may
return different null vectors; only the best set's refined pose and
inliers are compared across backends.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_system_tpu_torch.utils.precision import set_f32_policy

CHI2_GATE = 5.991  # per-point gate scaled by octave sigma2 (reference :103-105)
MIN_INLIERS = 10   # reference SetRansacParameters(0.99, 10, ...)

_PAIRS = ([0, 0, 0, 1, 1, 2], [1, 2, 3, 2, 3, 3])   # triu_indices(4, 1)


def _control_points(Xw, w):
    """4 control points [..., 4, 3]: the weighted centroid and the centroid
    plus the principal directions scaled by sqrt of their eigenvalues.
    Xw [..., N, 3], w [..., N]."""
    wsum = w.sum(-1).clamp_min(1e-9)
    c0 = (Xw * w[..., None]).sum(-2) / wsum[..., None]
    Xc = (Xw - c0[..., None, :]) * w.sqrt()[..., None]
    cov = Xc.mT @ Xc / wsum[..., None, None]
    eigval, eigvec = torch.linalg.eigh(cov)
    s = eigval.clamp_min(1e-9).sqrt()
    return torch.cat([c0[..., None, :],
                      c0[..., None, :] + (eigvec * s[..., None, :]).mT], dim=-2)


def _barycentric(Xw, ctrl):
    """alphas [..., N, 4] with Xw = sum_j alpha_j * ctrl_j, sum alpha = 1."""
    ones = torch.ones(ctrl.shape[:-2] + (1, 4), dtype=ctrl.dtype,
                      device=ctrl.device)
    M = torch.cat([ctrl.mT, ones], dim=-2)                         # [..., 4, 4]
    Xh = torch.cat([Xw, torch.ones_like(Xw[..., :1])], dim=-1)     # [..., N, 4]
    Xh = Xh.expand(M.shape[:-2] + Xh.shape[-2:])
    # solve_ex: a singular set gives non-finite alphas (as jnp.linalg.solve
    # does) instead of raising, and the card is not synchronised.
    return torch.linalg.solve_ex(M, Xh.mT)[0].mT


def _epnp_solve(Xw, uv, w, fx, fy, cx, cy):
    """Weighted EPnP over leading axes: Xw [..., N, 3], uv [N, 2], w [..., N]
    (0 excludes a point). Returns (R [..., 3, 3], t [..., 3])."""
    ctrl = _control_points(Xw, w)
    alphas = _barycentric(Xw, ctrl)                               # [..., N, 4]
    sw = w.clamp_min(0.0).sqrt()[..., None]
    u, v = uv[:, 0:1], uv[:, 1:2]
    zero = torch.zeros_like(alphas)
    # Unknowns [x1..x4, y1..y4, z1..z4] of the camera-frame control points.
    row_u = torch.cat([alphas * fx, zero, alphas * (cx - u)], dim=-1)
    row_v = torch.cat([zero, alphas * fy, alphas * (cy - v)], dim=-1)
    M = torch.cat([row_u * sw, row_v * sw], dim=-2)               # [..., 2N, 12]
    _, vecs = torch.linalg.eigh(M.mT @ M)
    # With >= 6-point sets the null space is effectively 1-dim: the
    # smallest eigenvector, scaled so the control point distances match.
    vker = vecs[..., :, 0]
    cps = torch.stack([vker[..., 0:4], vker[..., 4:8], vker[..., 8:12]], -1)
    i, j = _PAIRS
    d_w = (ctrl[..., i, :] - ctrl[..., j, :]).norm(dim=-1)
    d_c = (cps[..., i, :] - cps[..., j, :]).norm(dim=-1)
    beta = (d_w * d_c).sum(-1) / (d_c * d_c).sum(-1).clamp_min(1e-12)
    pts_cam = alphas @ (cps * beta[..., None, None])              # [..., N, 3]
    # Sign: the weighted points must lie in front of the camera.
    neg = (pts_cam[..., 2] * w).sum(-1) < 0
    pts_cam = pts_cam * torch.where(neg, -1.0, 1.0)[..., None, None]
    # Horn alignment world -> camera (Umeyama without scale).
    wsum = w.sum(-1).clamp_min(1e-9)[..., None]
    mu_w = (Xw * w[..., None]).sum(-2) / wsum
    mu_c = (pts_cam * w[..., None]).sum(-2) / wsum
    cov = ((pts_cam - mu_c[..., None, :]) * w[..., None]).mT \
        @ (Xw - mu_w[..., None, :]) / wsum[..., None]
    U, _, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U @ Vt))
    S = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d], dim=-1))
    R = U @ S @ Vt
    t = mu_c - (R @ mu_w[..., None])[..., 0]
    return R, t


def _inliers(R, t, Xw, uv, inv_sigma2, valid, fx, fy, cx, cy):
    """Reprojection gate: valid & chi2 <= CHI2_GATE & in front. R [..., 3, 3],
    t [..., 3], Xw [..., N, 3]; returns bool [..., N]."""
    Xc = Xw @ R.mT + t[..., None, :]
    z = Xc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    eu = uv[:, 0] - (fx * Xc[..., 0] / zs + cx)
    ev = uv[:, 1] - (fy * Xc[..., 1] / zs + cy)
    chi2 = (eu * eu + ev * ev) * inv_sigma2
    return valid & (chi2 <= CHI2_GATE) & (z > 0)


def set_weights(sel, valid):
    """Weights f32[C,S,N] of the minimal sets sel i64[C,S,K]: 1 at each
    index of a set, once however often the set repeats it (a scatter, as
    `.at[idx].set(1.0)`), and 0 where valid bool[C,N] is false."""
    C, S, _ = sel.shape
    w = torch.zeros((C, S, valid.shape[1]), device=sel.device)
    return w.scatter(2, sel, 1.0) * valid[:, None, :]


def epnp_ransac_batch(Xw, uv, inv_sigma2, valid, sample_sets,
                      fx, fy, cx, cy):
    """EPnP-RANSAC for C candidates sharing the current frame's
    observations: Xw f32[C,N,3] and valid bool[C,N] carry each candidate's
    3D associations; uv f32[N,2], inv_sigma2 f32[N] and sample_sets
    i64[S,K] (make_pnp_sample_sets) are shared. One batched pass, no
    per-candidate loop. Returns tensors (ok bool[C], Tcw f32[C,4,4],
    inliers bool[C,N], n_inliers i64[C])."""
    set_f32_policy()
    C, N = valid.shape
    dev = Xw.device
    # Sample indices remapped onto each candidate's valid slots.
    slot = torch.arange(N, device=dev).expand(C, N)
    order = torch.argsort(torch.where(valid, slot, 1 << 28), dim=1,
                          stable=True)
    n_valid = valid.sum(1).clamp_min(1)
    sel = order.gather(1, (sample_sets[None] % n_valid[:, None, None])
                       .reshape(C, -1)).reshape(C, *sample_sets.shape)
    w = set_weights(sel, valid)
    R, t = _epnp_solve(Xw[:, None], uv, w, fx, fy, cx, cy)        # [C,S,...]
    n_inl = _inliers(R, t, Xw[:, None], uv, inv_sigma2, valid[:, None],
                     fx, fy, cx, cy).sum(-1)
    best = n_inl.argmax(dim=1)                     # first maximum
    rows = torch.arange(C, device=dev)
    R_best, t_best = R[rows, best], t[rows, best]
    inl = _inliers(R_best, t_best, Xw, uv, inv_sigma2, valid, fx, fy, cx, cy)
    # Refine on all inliers (reference Refine :209); keep it when it
    # explains at least as many points.
    R_ref, t_ref = _epnp_solve(Xw, uv, inl.to(Xw.dtype), fx, fy, cx, cy)
    inl_r = _inliers(R_ref, t_ref, Xw, uv, inv_sigma2, valid, fx, fy, cx, cy)
    use_ref = inl_r.sum(-1) >= inl.sum(-1)
    R_f = torch.where(use_ref[:, None, None], R_ref, R_best)
    t_f = torch.where(use_ref[:, None], t_ref, t_best)
    inl_f = torch.where(use_ref[:, None], inl_r, inl)
    n_f = inl_f.sum(-1)
    T = torch.eye(4, dtype=Xw.dtype, device=dev).repeat(C, 1, 1)
    T[:, :3, :3] = R_f
    T[:, :3, 3] = t_f
    return n_f >= MIN_INLIERS, T, inl_f, n_f


def epnp_ransac(Xw, uv, inv_sigma2, valid, sample_sets, fx, fy, cx, cy):
    """epnp_ransac_batch for one candidate: Xw f32[N,3], valid bool[N].
    Returns (ok, Tcw f32[4,4], inliers bool[N], n_inliers)."""
    ok, T, inl, n = epnp_ransac_batch(Xw[None], uv, inv_sigma2, valid[None],
                                      sample_sets, fx, fy, cx, cy)
    return ok[0], T[0], inl[0], n[0]


def make_pnp_sample_sets(n_slots: int, n_sets: int = 300, seed: int = 0):
    """Deterministic minimal sets (reference RANSAC 300 iters max,
    src/Tracking.cc:822 SetRansacParameters(0.99, 10, 300, 4, 0.5, 5.991));
    the JAX package draws the same sets from the same generator."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, max(n_slots, 1), size=(n_sets, 6)).astype(np.int32)
