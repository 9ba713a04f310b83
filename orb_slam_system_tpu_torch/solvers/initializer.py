"""Two-view monocular initialization: parallel H/F RANSAC + reconstruction.

Port of orb_slam_system_tpu/solvers/initializer.py (reference Initializer:
Initialize, ComputeH21, ComputeF21, CheckHomography, CheckFundamental,
ReconstructF, ReconstructH, CheckRT). All 200 RANSAC hypotheses of both
models are scored in one batched pass each; model selection keeps the rule
RH = SH / (SH + SF) > 0.40; reconstruction checks all 4 (F) / 8 (H)
motion hypotheses at once.

Eigen- and singular vectors come back with the solver's own signs
(LAPACK on the CPU, cuSOLVER on the card, each possibly unlike XLA's). H
and F are only used up to scale, and the 4 / 8 motion hypotheses form the
same set whatever the signs (a joint sign flip of a singular pair swaps
hypotheses within the set), so R21, t21 and the points do not depend on
them; only the hypotheses' order can.

RANSAC sample indices come from `make_ransac_sets`, numpy with a fixed
seed, so the JAX package and the port score the same sets.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam_system_tpu_torch.solvers.triangulate import triangulate_dlt

SIGMA = 1.0                 # reference Initializer ctor sigma
TH_H = 5.991                # CheckHomography chi2 gate
TH_F = 3.841                # CheckFundamental chi2 gate
TH_SCORE = 5.991            # score cap used by both checks
MIN_PARALLAX_DEG = 1.0      # ReconstructF/H minParallax
MIN_TRIANGULATED = 50


class InitResult(NamedTuple):
    success: torch.Tensor         # bool
    used_homography: torch.Tensor  # bool
    R21: torch.Tensor             # f32[3,3] cam1 -> cam2
    t21: torch.Tensor             # f32[3] (unit-normalized)
    points3d: torch.Tensor        # f32[M,3] in cam1 frame
    is_triangulated: torch.Tensor  # bool[M]
    n_good: torch.Tensor          # i64


def make_ransac_sets(n_matches_slots: int, n_sets: int = 200, k: int = 8,
                     seed: int = 0) -> np.ndarray:
    """Host-side deterministic RANSAC index sets [n_sets, k]; indices are
    drawn over the slot range and remapped to valid matches on the device
    (a copy of the JAX package's function: same seed, same sets)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, max(n_matches_slots, 1), size=(n_sets, k)).astype(np.int32)


def _normalize(pts, valid):
    """Reference Normalize: zero-mean, unit mean-abs-dev per axis over the
    valid matches. Returns (pts_n, T 3x3)."""
    w = valid.to(pts.dtype)
    n = w.sum().clamp_min(1.0)
    mean = (pts * w[:, None]).sum(0) / n
    mean_dev = ((pts - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / mean_dev.clamp_min(1e-9)
    pts_n = (pts - mean) * s
    z = torch.zeros((), dtype=pts.dtype, device=pts.device)
    one = torch.ones((), dtype=pts.dtype, device=pts.device)
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, one])])
    return pts_n, T


def _smallest_eigvec(AtA):
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]


def _compute_h(p1, p2):
    """8-point homography DLT over S sets: p1, p2 [S,8,2] normalized.
    Returns H [S,3,3] with p2 ~ H p1."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    r2 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    A = torch.cat([r1, r2], dim=-2)                        # [S,16,9]
    return _smallest_eigvec(A.transpose(-1, -2) @ A).reshape(-1, 3, 3)


def _compute_f(p1, p2):
    """8-point fundamental DLT + rank-2 enforcement over S sets."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one],
                    -1)                                    # [S,8,9]
    F = _smallest_eigvec(A.transpose(-1, -2) @ A).reshape(-1, 3, 3)
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U * S[..., None, :]) @ Vh


def _homog(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)


def _score_h(H21, pts1, pts2, valid, sigma2):
    """Symmetric transfer error scoring (reference CheckHomography) of
    H21 [S,3,3]. Returns (score [S], inlier bool[S,M])."""
    H12 = torch.linalg.inv(H21)

    def transfer(H, a):
        b = _homog(a) @ H.transpose(-1, -2)               # [S,M,3]
        w = b[..., 2]
        ws = torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
        return b[..., :2] / ws[..., None]

    e21 = pts2 - transfer(H21, pts1)
    e12 = pts1 - transfer(H12, pts2)
    chi21 = (e21 * e21).sum(-1) / sigma2
    chi12 = (e12 * e12).sum(-1) / sigma2
    in21 = chi21 <= TH_H
    in12 = chi12 <= TH_H
    inlier = valid & in21 & in12
    zero = torch.zeros_like(chi21)
    score = (torch.where(valid & in21, TH_SCORE - chi21, zero)
             + torch.where(valid & in12, TH_SCORE - chi12, zero)).sum(-1)
    return score, inlier


def _score_f(F21, pts1, pts2, valid, sigma2):
    """Epipolar distance scoring (reference CheckFundamental) of F21
    [S,3,3]. Returns (score [S], inlier bool[S,M])."""
    p1h = _homog(pts1)
    p2h = _homog(pts2)
    l2 = p1h @ F21.transpose(-1, -2)      # lines in image 2
    l1 = p2h @ F21                        # lines in image 1
    d2 = (l2 * p2h).sum(-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp_min(1e-12)
    d1 = (l1 * p1h).sum(-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2).clamp_min(1e-12)
    chi2_2 = d2 / sigma2
    chi2_1 = d1 / sigma2
    in2 = chi2_2 <= TH_F
    in1 = chi2_1 <= TH_F
    inlier = valid & in1 & in2
    zero = torch.zeros_like(chi2_2)
    score = (torch.where(valid & in2, TH_SCORE - chi2_2, zero)
             + torch.where(valid & in1, TH_SCORE - chi2_1, zero)).sum(-1)
    return score, inlier


def _check_rt(R, t, pts1, pts2, valid, K, sigma2):
    """Cheirality + reprojection test (reference CheckRT) of the motion
    hypotheses R [Hn,3,3], t [Hn,3]: triangulate all valid matches with
    P1 = K[I|0], P2 = K[R|t]; require finite, positive depth in both views,
    parallax cos < 0.99998 and reprojection error < 4 sigma^2 in both
    images. Returns (n_good [Hn], good [Hn,M], parallax_deg [Hn],
    X [Hn,M,3])."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    P1 = torch.cat([K, torch.zeros((3, 1), dtype=K.dtype, device=K.device)], 1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)          # [Hn,3,4]
    X, w_ok = triangulate_dlt(pts1, pts2, P1, P2)         # [Hn,M,3]
    finite = torch.isfinite(X).all(-1) & w_ok
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]     # [Hn,3]
    n2 = X - O2[:, None, :]
    d1 = torch.linalg.vector_norm(X, dim=-1)
    d2 = torch.linalg.vector_norm(n2, dim=-1)
    cos_par = (X * n2).sum(-1) / (d1 * d2).clamp_min(1e-12)
    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    depth_ok = (X[..., 2] > 0) & (Xc2[..., 2] > 0)

    def reproj_err(Xc, pts):
        zc = Xc[..., 2]
        zc = torch.where(zc.abs() < 1e-9, torch.full_like(zc, 1e-9), zc)
        e = pts - torch.stack([fx * Xc[..., 0] / zc + cx,
                               fy * Xc[..., 1] / zc + cy], -1)
        return (e * e).sum(-1)

    good = (valid & finite & depth_ok & (cos_par < 0.99998)
            & (reproj_err(X, pts1) < 4.0 * sigma2)
            & (reproj_err(Xc2, pts2) < 4.0 * sigma2))
    n_good = good.sum(-1)
    # Parallax: the 50th-smallest cosine among good points.
    cp = torch.where(good, cos_par, torch.ones_like(cos_par))
    cp_sorted = torch.sort(cp, dim=-1).values
    idx = (n_good - 1).clamp(0, 49)
    c = cp_sorted.gather(-1, idx[:, None])[:, 0].clamp(-1.0, 1.0)
    parallax = torch.where(n_good > 0, torch.rad2deg(torch.arccos(c)),
                           torch.zeros_like(c))
    return n_good, good, parallax, X


def _reconstruct_f(F21, pts1, pts2, inlier, K, sigma2):
    """Reference ReconstructF: E decomposed into 4 hypotheses, winner take
    all with ambiguity rejection."""
    E = K.T @ F21 @ K
    U, _, Vh = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=K.dtype, device=K.device)
    R1 = U @ W @ Vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = U @ W.T @ Vh
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tu = U[:, 2]
    tu = tu / torch.linalg.vector_norm(tu).clamp_min(1e-12)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([tu, -tu, tu, -tu])
    n_good, good, par, X = _check_rt(Rs, ts, pts1, pts2, inlier, K, sigma2)
    n_inl = inlier.sum()
    max_good = n_good.max()
    best = torch.argmax(n_good)
    n_similar = (n_good > 0.7 * max_good).sum()
    min_good = torch.clamp_min((0.9 * n_inl).to(torch.int64), MIN_TRIANGULATED)
    ok = (max_good >= min_good) & (n_similar == 1) & (par[best] > MIN_PARALLAX_DEG)
    return ok, Rs[best], ts[best], X[best], good[best], n_good[best]


def _reconstruct_h(H21, pts1, pts2, inlier, K, sigma2):
    """Reference ReconstructH (Faugeras & Lustman 8-solution
    decomposition of A = K^-1 H K), all 8 checked at once."""
    A = torch.linalg.inv(K) @ H21 @ K
    U, S, Vh = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = S[0], S[1], S[2]
    eps = 1e-12
    den13 = (d1 * d1 - d3 * d3).clamp_min(eps)
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / den13).clamp_min(0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / den13).clamp_min(0.0))
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=K.dtype, device=K.device)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=K.dtype, device=K.device)
    x1 = e1 * aux1
    x3 = e3 * aux3
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp_min(0.0))
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)

    def hypotheses(c, sn, d_sign, t_sign, scale):
        # Rp per hypothesis: d' = +d2 -> [[c,0,-sn],[0,1,0],[sn,0,c]];
        # d' = -d2 -> [[c,0,sn],[0,-1,0],[sn,0,-c]].
        cc = c * one
        Rp = torch.stack([
            torch.stack([cc, zero, -d_sign * sn], -1),
            torch.stack([zero, d_sign * one, zero], -1),
            torch.stack([sn, zero, d_sign * cc], -1)], -2)   # [4,3,3]
        R = s * (U @ Rp @ Vh)
        t = (U @ torch.stack([x1, zero, t_sign * x3], -1)[..., None])[..., 0]
        t = t * scale
        return R, t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(eps)

    sin_t = root / ((d1 + d3) * d2).clamp_min(eps)
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp_min(eps)
    Rp_list, tp_list = hypotheses(cos_t, e1 * e3 * sin_t, 1.0, -1.0, d1 - d3)
    sin_p = root / ((d1 - d3) * d2).clamp_min(eps)
    cos_p = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp_min(eps)
    Rn_list, tn_list = hypotheses(cos_p, e1 * e3 * sin_p, -1.0, 1.0, d1 + d3)
    Rs = torch.cat([Rp_list, Rn_list])
    ts = torch.cat([tp_list, tn_list])
    n_good, good, par, X = _check_rt(Rs, ts, pts1, pts2, inlier, K, sigma2)
    n_inl = inlier.sum()
    best = torch.argmax(n_good)
    best_good = n_good[best]
    second_good = torch.where(torch.arange(8, device=K.device) == best,
                              torch.full_like(n_good, -1), n_good).max()
    ok = ((second_good < 0.75 * best_good) & (par[best] > MIN_PARALLAX_DEG)
          & (best_good > MIN_TRIANGULATED) & (best_good > 0.9 * n_inl))
    return ok, Rs[best], ts[best], X[best], good[best], best_good


def initialize_two_view(pts1, pts2, valid, ransac_sets, K) -> InitResult:
    """Full two-view bootstrap (reference Initialize).

    pts1/pts2: f32[M,2] undistorted pixel coords of the matched pairs
    (slot-aligned; `valid` marks real matches). ransac_sets: int[S,8]
    index sets into the M slots. K: f32[3,3]. All on one device.

    Returns InitResult with the relative pose (R21, t21) and triangulated
    points in camera-1 coordinates."""
    sigma2 = SIGMA * SIGMA
    M = pts1.shape[0]
    dev = pts1.device
    # Remap RANSAC indices onto valid slots (valid slots first, in order).
    slot_ids = torch.arange(M, device=dev)
    order = torch.argsort(torch.where(valid, slot_ids,
                                      torch.full_like(slot_ids, 1 << 28)),
                          stable=True)
    n_valid = valid.sum().clamp_min(1)
    sel = order[ransac_sets.to(torch.int64) % n_valid]     # [S,8]

    p1n, T1 = _normalize(pts1, valid)
    p2n, T2 = _normalize(pts2, valid)
    Hs = torch.linalg.inv(T2) @ _compute_h(p1n[sel], p2n[sel]) @ T1
    Fs = T2.T @ _compute_f(p1n[sel], p2n[sel]) @ T1
    scores_h, _ = _score_h(Hs, pts1, pts2, valid, sigma2)
    scores_f, _ = _score_f(Fs, pts1, pts2, valid, sigma2)
    bi_h = torch.argmax(scores_h)
    bi_f = torch.argmax(scores_f)
    SH, SF = scores_h[bi_h], scores_f[bi_f]
    H21, F21 = Hs[bi_h], Fs[bi_f]
    inlier_h = _score_h(H21[None], pts1, pts2, valid, sigma2)[1][0]
    inlier_f = _score_f(F21[None], pts1, pts2, valid, sigma2)[1][0]
    use_h = SH / (SH + SF).clamp_min(1e-9) > 0.40

    ok_h, Rh, th, Xh, good_h, n_h = _reconstruct_h(
        H21, pts1, pts2, inlier_h, K, sigma2)
    ok_f, Rf, tf, Xf, good_f, n_f = _reconstruct_f(
        F21, pts1, pts2, inlier_f, K, sigma2)
    return InitResult(
        success=torch.where(use_h, ok_h, ok_f),
        used_homography=use_h,
        R21=torch.where(use_h, Rh, Rf),
        t21=torch.where(use_h, th, tf),
        points3d=torch.where(use_h, Xh, Xf),
        is_triangulated=torch.where(use_h, good_h, good_f),
        n_good=torch.where(use_h, n_h, n_f))

