"""Windowed / global bundle adjustment: batched LM with Schur complement.

Port of orb_slam_system_tpu/solvers/local_ba.py (reference
Optimizer::BundleAdjustment and Optimizer::LocalBundleAdjustment: SE3
cameras, marginalized XYZ points, Huber(sqrt(5.991)) mono reprojection
edges with information invSigma2 * I).

  * Fixed-shape problem: C cameras, P points, E edges (COO triplets
    cam/pt/uv) with validity masks.
  * Per LM iteration: residuals and Jacobians batched over the edges;
    camera and point Hessian blocks and the camera-point cross blocks are
    segment sums over the edges; the 3x3 point blocks are inverted in
    closed form; the reduced camera system (Schur complement) is a dense
    (6C x 6C) solve in full f32.
  * Segment sums are `index_put_(..., accumulate=True)`, which sorts the
    indices and sums each run in order on the card (and in a serial loop
    on the CPU): deterministic run to run, unlike `index_add_` on CUDA
    floats. The JAX package's one-hot matmuls are its TPU workaround and
    are not carried over.
  * The LM loop is a Python loop of tensor ops with accept/reject damping
    chosen on the device (no host sync inside); the reference's two-stage
    local schedule is 5 robust iterations, the chi2 > 5.991 edges dropped,
    10 more (`local_bundle_adjustment`).
  * `bundle_adjust_cg` solves the reduced camera system by preconditioned
    CG over per-edge blocks instead of the dense Schur complement: the
    global BA after a loop closure takes it once the map outgrows the dense
    solve (models/loop_closing.GBA_DENSE_MAX_CAMS).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam_system_tpu_torch.utils.lie import se3_exp

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_DELTA = 2.447731         # sqrt(5.991)
HUBER_DELTA_STEREO = 2.795532  # sqrt(7.815)


class BAProblem(NamedTuple):
    Tcw: torch.Tensor          # f32[C,4,4]
    cam_fixed: torch.Tensor    # bool[C]
    cam_valid: torch.Tensor    # bool[C]
    points: torch.Tensor       # f32[P,3]
    pt_valid: torch.Tensor     # bool[P]
    e_cam: torch.Tensor        # i64[E]
    e_pt: torch.Tensor         # i64[E]
    e_uv: torch.Tensor         # f32[E,2]
    e_inv_sigma2: torch.Tensor  # f32[E]
    e_valid: torch.Tensor      # bool[E]
    e_ur: Optional[torch.Tensor] = None  # f32[E] right-view u (-1 = mono)
    bf: float = 0.0            # stereo baseline * fx

    def ur(self):
        return (self.e_ur if self.e_ur is not None
                else torch.full(self.e_cam.shape, -1.0,
                                device=self.e_cam.device))


def _seg_sum(idx, blocks, n):
    """sum blocks[e] into out[idx[e]]: [E,...] -> [n,...], deterministic."""
    out = torch.zeros((n,) + blocks.shape[1:], dtype=blocks.dtype,
                      device=blocks.device)
    return out.index_put_((idx,), blocks, accumulate=True)


def _edge_residuals(xi_all, dX, prob: BAProblem, fx, fy, cx, cy):
    """Residuals and Jacobians of all edges at the perturbed state.
    xi_all: f32[C,6] se3 updates (left-multiplied); dX: f32[P,3]."""
    T = se3_exp(xi_all) @ prob.Tcw                       # [C,4,4]
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    Xe = (prob.points + dX)[prob.e_pt]                   # [E,3]
    Re = R[prob.e_cam]                                   # [E,3,3]
    Xc = (Re @ Xe[:, :, None])[:, :, 0] + t[prob.e_cam]
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    e_ur = prob.ur()
    is_stereo = e_ur >= 0
    ur = u - prob.bf * inv_z
    e = torch.stack([prob.e_uv[:, 0] - u, prob.e_uv[:, 1] - v,
                     torch.where(is_stereo, e_ur - ur, torch.zeros_like(u))],
                    dim=1)                               # [E,3]
    zero = torch.zeros_like(x)
    J_proj = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], 1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], 1),
        torch.stack([fx * inv_z, zero, (-fx * x + prob.bf) * inv_z * inv_z], 1),
    ], dim=1)                                            # [E,3,3]
    row_mask = torch.ones((Xc.shape[0], 3), dtype=Xc.dtype, device=Xc.device)
    row_mask[:, 2] = is_stereo.to(Xc.dtype)
    J_proj = J_proj * row_mask[:, :, None]
    px, py, pz = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    nh = torch.stack([torch.stack([zero, pz, -py], 1),
                      torch.stack([-pz, zero, px], 1),
                      torch.stack([py, -px, zero], 1)], dim=1)   # [E,3,3]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand_as(nh)
    J_xc_cam = torch.cat([eye, nh], dim=2)               # [E,3,6]
    Jc = -(J_proj @ J_xc_cam)                            # [E,3,6]
    Jp = -(J_proj @ Re)                                  # [E,3,3]
    return e, Jc, Jp, z, is_stereo


def _robust_cost(e, inv_sigma2, active, use_huber, is_stereo):
    chi2 = (e * e).sum(1) * inv_sigma2
    delta = torch.where(is_stereo, HUBER_DELTA_STEREO, HUBER_DELTA)
    rho = chi2
    if use_huber:
        rho = torch.where(
            chi2 > delta * delta,
            2.0 * delta * torch.sqrt(chi2.clamp_min(1e-12)) - delta * delta,
            chi2)
    return torch.where(active, rho, torch.zeros_like(rho)).sum(), chi2


def _inv3x3(M):
    """Closed-form batched 3x3 inverse with a damping-safe determinant."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], dim=-2)
    return inv / det[..., None, None]


def bundle_adjust(prob: BAProblem, fx, fy, cx, cy, n_iters: int = 10,
                  use_huber: bool = True):
    """n_iters LM iterations; returns (Tcw_new, points_new)."""
    C = prob.Tcw.shape[0]
    P = prob.points.shape[0]
    dev = prob.points.device
    f32 = prob.points.dtype
    free_cam = (~prob.cam_fixed) & prob.cam_valid
    fm = free_cam.to(f32)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    idxC = torch.arange(C, device=dev)
    e_cp = prob.e_cam * P + prob.e_pt                   # (cam, pt) block
    zero_xi = torch.zeros((C, 6), dtype=f32, device=dev)
    zero_dx = torch.zeros((P, 3), dtype=f32, device=dev)

    def cost_at(Tcw, X, xi_all, dX):
        p = prob._replace(Tcw=Tcw, points=X)
        e, _, _, z, is_st = _edge_residuals(xi_all, dX, p, fx, fy, cx, cy)
        return _robust_cost(e, prob.e_inv_sigma2, prob.e_valid & (z > 0),
                            use_huber, is_st)[0]

    Tcw = prob.Tcw.to(f32)
    X = prob.points.to(f32)
    lam = torch.tensor(1e-4, dtype=f32, device=dev)
    for _ in range(n_iters):
        p = prob._replace(Tcw=Tcw, points=X)
        e, Jc, Jp, z, is_st = _edge_residuals(zero_xi, zero_dx, p,
                                              fx, fy, cx, cy)
        chi2 = (e * e).sum(1) * prob.e_inv_sigma2
        w_h = torch.ones_like(chi2)
        if use_huber:
            delta_e = torch.where(is_st, HUBER_DELTA_STEREO, HUBER_DELTA)
            w_h = torch.clamp_max(delta_e / torch.sqrt(chi2.clamp_min(1e-12)),
                                  1.0)
        active = prob.e_valid & (z > 0)
        w = torch.where(active, w_h * prob.e_inv_sigma2, torch.zeros_like(w_h))
        wJc = w[:, None, None] * Jc
        wJp = w[:, None, None] * Jp
        Hcc = _seg_sum(prob.e_cam, wJc.transpose(1, 2) @ Jc, C)       # [C,6,6]
        Hpp = _seg_sum(prob.e_pt, wJp.transpose(1, 2) @ Jp, P)        # [P,3,3]
        gc = _seg_sum(prob.e_cam, (wJc.transpose(1, 2) @ e[:, :, None])[..., 0], C)
        gp = _seg_sum(prob.e_pt, (wJp.transpose(1, 2) @ e[:, :, None])[..., 0], P)
        A_cp = _seg_sum(e_cp, wJc.transpose(1, 2) @ Jp,
                        C * P).reshape(C, P, 6, 3)
        # LM damping (multiplicative on the block diagonals).
        Hcc_d = Hcc + lam * eye6 * torch.diagonal(
            Hcc, dim1=1, dim2=2).clamp_min(1e-6)[:, :, None]
        Hpp_d = Hpp + lam * eye3 * torch.diagonal(
            Hpp, dim1=1, dim2=2).clamp_min(1e-6)[:, :, None]
        pt_ok = prob.pt_valid & (torch.diagonal(Hpp, dim1=1, dim2=2).sum(1) > 1e-9)
        Hpp_inv = torch.where(pt_ok[:, None, None], _inv3x3(Hpp_d),
                              torch.zeros_like(Hpp_d))
        # Schur complement S = Hcc - A Hpp^-1 A^T (blocks [C,6,C,6]).
        AH = torch.einsum("cpij,pjk->cpik", A_cp, Hpp_inv)         # [C,P,6,3]
        S = -torch.einsum("cpik,dplk->cidl", AH, A_cp)             # [C,6,C,6]
        S[idxC, :, idxC, :] += Hcc_d
        rhs = -gc + torch.einsum("cpik,pk->ci", AH, gp)            # [C,6]
        # Fixed cameras: zero rows/cols, identity diagonal.
        S = S * fm[:, None, None, None] * fm[None, None, :, None]
        S[idxC, :, idxC, :] += (1.0 - fm)[:, None, None] * eye6
        rhs = rhs * fm[:, None]
        dc = torch.linalg.solve(S.reshape(C * 6, C * 6),
                                rhs.reshape(C * 6)).reshape(C, 6)
        # Back-substitute the points: dp = Hpp^-1 (-gp - A^T dc).
        Atdc = torch.einsum("cpij,ci->pj", A_cp, dc)
        dp = torch.einsum("pjk,pk->pj", Hpp_inv, -gp - Atdc)
        dp = torch.where(pt_ok[:, None], dp, torch.zeros_like(dp))
        improved = cost_at(Tcw, X, dc, dp) < cost_at(Tcw, X, zero_xi, zero_dx)
        Tcw = torch.where(improved, se3_exp(dc) @ Tcw, Tcw)
        X = torch.where(improved, X + dp, X)
        lam = torch.where(improved, lam * 0.5, lam * 4.0).clamp(1e-10, 1e8)
    return Tcw, X


def bundle_adjust_cg(prob: BAProblem, fx, fy, cx, cy, n_iters: int = 10,
                     cg_iters: int = 40):
    """LM bundle adjustment whose reduced camera system is solved by
    preconditioned CG, with the matvec assembled from per-edge blocks (the
    dense [C,P,6,3] cross blocks of `bundle_adjust` are never formed): O(E)
    per CG iteration, for global BA over large maps. Huber-robust, as
    bundle_adjust by default; returns (Tcw_new, points_new)."""
    C = prob.Tcw.shape[0]
    P = prob.points.shape[0]
    dev = prob.points.device
    f32 = prob.points.dtype
    fm = ((~prob.cam_fixed) & prob.cam_valid).to(f32)[:, None]
    eye6 = torch.eye(6, dtype=f32, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    zero_xi = torch.zeros((C, 6), dtype=f32, device=dev)
    zero_dx = torch.zeros((P, 3), dtype=f32, device=dev)

    def cost_at(Tcw, X, xi_all, dX):
        p = prob._replace(Tcw=Tcw, points=X)
        e, _, _, z, is_st = _edge_residuals(xi_all, dX, p, fx, fy, cx, cy)
        return _robust_cost(e, prob.e_inv_sigma2, prob.e_valid & (z > 0),
                            True, is_st)[0]

    def bmv(M, x):
        return (M @ x[..., None])[..., 0]

    Tcw = prob.Tcw.to(f32)
    X = prob.points.to(f32)
    lam = torch.tensor(1e-4, dtype=f32, device=dev)
    for _ in range(n_iters):
        p = prob._replace(Tcw=Tcw, points=X)
        e, Jc, Jp, z, is_st = _edge_residuals(zero_xi, zero_dx, p,
                                              fx, fy, cx, cy)
        chi2 = (e * e).sum(1) * prob.e_inv_sigma2
        delta_e = torch.where(is_st, HUBER_DELTA_STEREO, HUBER_DELTA)
        w_h = torch.clamp_max(delta_e / torch.sqrt(chi2.clamp_min(1e-12)), 1.0)
        active = prob.e_valid & (z > 0)
        w = torch.where(active, w_h * prob.e_inv_sigma2, torch.zeros_like(w_h))
        sw = torch.sqrt(w)
        Jc_w = Jc * sw[:, None, None]                    # weight-absorbed
        Jp_w = Jp * sw[:, None, None]
        e_w = e * sw[:, None]
        JcT, JpT = Jc_w.transpose(1, 2), Jp_w.transpose(1, 2)
        Hcc = _seg_sum(prob.e_cam, JcT @ Jc_w, C)
        Hpp = _seg_sum(prob.e_pt, JpT @ Jp_w, P)
        gc = _seg_sum(prob.e_cam, bmv(JcT, e_w), C)
        gp = _seg_sum(prob.e_pt, bmv(JpT, e_w), P)
        Hcc_d = Hcc + lam * eye6 * torch.diagonal(
            Hcc, dim1=1, dim2=2).clamp_min(1e-6)[:, :, None]
        Hpp_d = Hpp + lam * eye3 * torch.diagonal(
            Hpp, dim1=1, dim2=2).clamp_min(1e-6)[:, :, None]
        pt_ok = prob.pt_valid & (torch.diagonal(Hpp, dim1=1, dim2=2).sum(1) > 1e-9)
        Hpp_inv = torch.where(pt_ok[:, None, None], _inv3x3(Hpp_d),
                              torch.zeros_like(Hpp_d))

        def A_t(x_c):
            """A^T x: [C,6] -> [P,3] through the per-edge blocks."""
            return _seg_sum(prob.e_pt, bmv(JpT, bmv(Jc_w, x_c[prob.e_cam])), P)

        def A_(v_p):
            """A v: [P,3] -> [C,6]."""
            return _seg_sum(prob.e_cam, bmv(JcT, bmv(Jp_w, v_p[prob.e_pt])), C)

        def schur_mv(x_c):
            x_c = x_c * fm
            y = bmv(Hcc_d, x_c) - A_(bmv(Hpp_inv, A_t(x_c)))
            # Fixed cameras act as the identity (keeps PCG well posed).
            return y * fm + x_c * (1.0 - fm)

        rhs = (-gc + A_(bmv(Hpp_inv, gp))) * fm
        Minv = torch.linalg.inv(Hcc_d + 1e-6 * eye6)

        def precond(x):
            return bmv(Minv, x) * fm

        x = torch.zeros((C, 6), dtype=f32, device=dev)
        r_cg = rhs
        zv = precond(r_cg)
        pv = zv
        rz = (r_cg * zv).sum()
        for _ in range(cg_iters):
            Ap = schur_mv(pv)
            denom = (pv * Ap).sum()
            alpha = rz / torch.where(denom.abs() < 1e-12,
                                     torch.full_like(denom, 1e-12), denom)
            x = x + alpha * pv
            r_cg = r_cg - alpha * Ap
            z_new = precond(r_cg)
            rz_new = (r_cg * z_new).sum()
            beta = rz_new / torch.where(rz.abs() < 1e-12,
                                        torch.full_like(rz, 1e-12), rz)
            pv = z_new + beta * pv
            rz = rz_new
        dc = x * fm
        dp = bmv(Hpp_inv, -gp - A_t(dc))
        dp = torch.where(pt_ok[:, None], dp, torch.zeros_like(dp))
        improved = cost_at(Tcw, X, dc, dp) < cost_at(Tcw, X, zero_xi, zero_dx)
        Tcw = torch.where(improved, se3_exp(dc) @ Tcw, Tcw)
        X = torch.where(improved, X + dp, X)
        lam = torch.where(improved, lam * 0.5, lam * 4.0).clamp(1e-10, 1e8)
    return Tcw, X


def classify_outliers(Tcw, points, prob: BAProblem, fx, fy, cx, cy):
    """Per-edge chi2 gate (reference :692-738): returns (bool[E] inlier
    mask: chi2 <= 5.991 (7.815 stereo) and positive depth, chi2 f32[E])."""
    p = prob._replace(Tcw=Tcw, points=points)
    C, P = Tcw.shape[0], points.shape[0]
    e, _, _, z, is_st = _edge_residuals(
        torch.zeros((C, 6), dtype=points.dtype, device=points.device),
        torch.zeros((P, 3), dtype=points.dtype, device=points.device),
        p, fx, fy, cx, cy)
    chi2 = (e * e).sum(1) * prob.e_inv_sigma2
    gate = torch.where(is_st, CHI2_STEREO, CHI2_MONO)
    return prob.e_valid & (z > 0) & (chi2 <= gate), chi2


def local_bundle_adjustment(prob: BAProblem, fx, fy, cx, cy):
    """The reference two-stage schedule: 5 robust iterations, drop outlier
    edges, 10 more without them. Returns (Tcw, points, edge_inlier)."""
    Tcw, X = bundle_adjust(prob, fx, fy, cx, cy, n_iters=5, use_huber=True)
    inlier, _ = classify_outliers(Tcw, X, prob, fx, fy, cx, cy)
    prob2 = prob._replace(Tcw=Tcw, points=X, e_valid=inlier)
    Tcw, X = bundle_adjust(prob2, fx, fy, cx, cy, n_iters=10, use_huber=False)
    inlier, _ = classify_outliers(Tcw, X, prob2, fx, fy, cx, cy)
    return Tcw, X, inlier


def local_bundle_adjustment_packed(prob: BAProblem, fx, fy, cx, cy):
    """local_bundle_adjustment with its three results packed into one flat
    f32 tensor [C*16 + P*3 + E], so the host fetches once."""
    Tcw, X, inl = local_bundle_adjustment(prob, fx, fy, cx, cy)
    return torch.cat([Tcw.reshape(-1), X.reshape(-1), inl.to(X.dtype)])


def unpack_local_ba(buf: np.ndarray, C: int, P: int, E: int):
    """Host-side split of local_bundle_adjustment_packed's buffer."""
    Tcw = buf[:C * 16].reshape(C, 4, 4)
    X = buf[C * 16:C * 16 + P * 3].reshape(P, 3)
    inl = buf[C * 16 + P * 3:] > 0.5
    return Tcw, X, inl


def global_bundle_adjustment(prob: BAProblem, fx, fy, cx, cy, n_iters=20):
    """Reference GlobalBundleAdjustemnt: the cameras marked fixed stay,
    Huber kernel, n_iters iterations. Returns (Tcw, points, inlier)."""
    Tcw, X = bundle_adjust(prob, fx, fy, cx, cy, n_iters=n_iters,
                           use_huber=True)
    inlier, _ = classify_outliers(Tcw, X, prob, fx, fy, cx, cy)
    return Tcw, X, inlier
