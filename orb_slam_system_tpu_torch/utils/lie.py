"""SO3 / SE3 / Sim3 operations on torch tensors.

Port of orb_slam_system_tpu/utils/lie.py (the reference's g2o SE3Quat and
Sim3 plus the Converter quaternion conversions). Conventions as in the JAX
package: rotations are 3x3, transforms Tcw are 4x4 [R t; 0 1], se3 tangents
are [rho(3), phi(3)] (translation first), sim3 tangents [rho, phi, sigma]
with scale s = exp(sigma), and a Sim3 is a dict {"R", "t", "s"}. The JAX
functions work on one element under jax.vmap; here every function except
se3_inv and the projections takes any leading axes itself, and the Sim3,
log and quaternion functions write nothing in place, so torch.func.jvp
and vmap go through them.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 hat operator: w [..., 3] -> skew-symmetric [..., 3, 3]."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def _coeffs(w: torch.Tensor):
    """Rodrigues coefficients A = sin t / t, B = (1 - cos t) / t^2,
    C = (t - sin t) / t^3 of w [..., 3], each [..., 1, 1], with Taylor
    guards near t = 0."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    t2s = torch.where(big, theta2, torch.ones_like(theta2))
    A = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    B = torch.where(big, (1.0 - torch.cos(theta)) / t2s, 0.5 - theta2 / 24.0)
    C = torch.where(big, (theta - torch.sin(theta)) / (t2s * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    return A[..., None, None], B[..., None, None], C[..., None, None]


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, numerically safe near theta = 0: w [..., 3] ->
    R [..., 3, 3]."""
    A, B, _ = _coeffs(w)
    W = hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * W + B * (W @ W)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V = I + B W + C W^2, the SO3 left Jacobian of w [..., 3]."""
    _, B, C = _coeffs(w)
    W = hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + B * W + C * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 [..., 6] [rho, phi] -> SE3 [..., 4, 4] over any leading axes (the
    JAX package's lie.se3_exp, and its jax.vmap)."""
    rho, w = xi[..., :3], xi[..., 3:6]
    A, B, C = _coeffs(w)
    W = hat(w)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A * W + B * WW
    t = ((eye + B * W + C * WW) @ rho[..., None])[..., 0]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = torch.eye(4, dtype=T.dtype, device=T.device)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -R.T @ t
    return Ti


def so3_project(R: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Closest rotation (polar factor) by the Newton-Schulz iteration
    X <- X(3I - X^T X)/2 after scaling to Frobenius norm sqrt(3).
    Requires det(R) > 0."""
    X = R * torch.rsqrt(torch.clamp_min((R * R).sum() / 3.0, 1e-12))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        X = 0.5 * (X @ (3.0 * eye - X.T @ X))
    return X


def se3_project(T: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Re-orthonormalize the rotation block of a 4x4 pose, keeping t."""
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = so3_project(T[:3, :3], iters)
    out[:3, 3] = T[:3, 3]
    return out


def quat_from_rot(R) -> np.ndarray:
    """Rotation matrix (numpy 3x3) -> unit quaternion (x, y, z, w), TUM
    trajectory order (the JAX package's lie.quat_from_rot, on the host).
    Case choice: w when the trace is positive, else the largest diagonal
    entry. The JAX version indexes its cases one off there (m00 largest
    takes the y case), which loses precision when 1 + m11 - m00 - m22 is
    near 0; both agree whenever the trace is positive."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    eps = _EPS
    if tr > 0:
        s = np.sqrt(max(tr + 1.0, eps)) * 2.0
        q = [(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s]
    else:
        case = int(np.argmax([m00, m11, m22]))
        if case == 0:
            s = np.sqrt(max(1.0 + m00 - m11 - m22, eps)) * 2.0
            q = [0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s]
        elif case == 1:
            s = np.sqrt(max(1.0 + m11 - m00 - m22, eps)) * 2.0
            q = [(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s]
        else:
            s = np.sqrt(max(1.0 + m22 - m00 - m11, eps)) * 2.0
            q = [(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def _quat_from_rot(R: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3] -> unit quaternion (x, y, z, w) [..., 4], branch-free:
    the w case when the trace is positive, else the largest diagonal entry's
    own case (quat_from_rot's choice; the JAX version's is one off there)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp_min(x, _EPS)) * 2.0

    sw = root(tr + 1.0)
    qw = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw,
                      0.25 * sw], -1)
    sx = root(1.0 + m00 - m11 - m22)
    qx = torch.stack([0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx,
                      (m21 - m12) / sx], -1)
    sy = root(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy,
                      (m02 - m20) / sy], -1)
    sz = root(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz,
                      (m10 - m01) / sz], -1)
    case = torch.stack([m00, m11, m22], -1).argmax(-1)[..., None]
    q = torch.where((tr > 0)[..., None], qw,
                    torch.where(case == 0, qx, torch.where(case == 1, qy, qz)))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO3 -> so3 through the unit quaternion, stable at all angles
    including near pi: R [..., 3, 3] -> w [..., 3]. Equal to the JAX
    package's so3_log wherever the trace is positive; elsewhere this one
    takes the largest diagonal entry's case (see _quat_from_rot)."""
    q = _quat_from_rot(R)
    q = torch.where(q[..., 3:] < 0, -q, q)     # angle in [0, pi]
    qv = q[..., :3]
    norm2 = (qv * qv).sum(-1)
    big = norm2 > 1e-12
    sin_half = torch.sqrt(torch.where(big, norm2, torch.ones_like(norm2)))
    theta = 2.0 * torch.atan2(sin_half, q[..., 3])
    scale = torch.where(big, theta / sin_half, torch.full_like(theta, 2.0))
    return scale[..., None] * qv


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE3 [..., 4, 4] -> se3 [..., 6] [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    rho = torch.linalg.solve(_so3_left_jacobian(phi), T[..., :3, 3:])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_apply(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply SE3 [..., 4, 4] to points X [..., N, 3]."""
    return X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def rot_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) [..., 4] -> rotation matrix [..., 3, 3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


# ---- Sim3 (loop closing; reference g2o/types/sim3.h) -------------------------


def sim3_make(R: torch.Tensor, t: torch.Tensor, s) -> dict:
    return {"R": R, "t": t, "s": torch.as_tensor(s, dtype=t.dtype,
                                                 device=t.device)}


def sim3_apply(S: dict, X: torch.Tensor) -> torch.Tensor:
    """s R X + t for points X [..., N, 3] under a Sim3 with leading axes."""
    return (S["s"][..., None, None] * (X @ S["R"].transpose(-1, -2))
            + S["t"][..., None, :])


def sim3_mul(A: dict, B: dict) -> dict:
    """A after B: (sA RA, tA) (sB RB, tB) = (sA sB RA RB, sA RA tB + tA)."""
    return {"R": A["R"] @ B["R"],
            "t": A["s"][..., None] * (A["R"] @ B["t"][..., None])[..., 0]
            + A["t"],
            "s": A["s"] * B["s"]}


def sim3_inv(S: dict) -> dict:
    Rinv = S["R"].transpose(-1, -2)
    sinv = 1.0 / S["s"]
    return {"R": Rinv, "t": -sinv[..., None] * (Rinv @ S["t"][..., None])[..., 0],
            "s": sinv}


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The matrix W [..., 3, 3] with t = W rho in sim3_exp (Strasdat's
    closed form, Sophus RxSO3 style), with Taylor guards near zero angle and
    zero scale. The JAX package builds it column by column through sim3_exp
    with unit rho; it is the same matrix."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    eps = 1e-5
    nz_sigma = sigma.abs() < eps
    nz_theta = theta < eps

    def nz(x):
        # Safe denominator for the branches torch.where discards.
        return torch.where(x.abs() < _EPS, torch.ones_like(x), x)

    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = torch.where(nz_theta, torch.ones_like(theta2), theta2 + sigma * sigma)
    A = torch.where(
        nz_sigma,
        torch.where(nz_theta, torch.full_like(theta, 0.5),
                    (1.0 - torch.cos(theta)) / nz(theta2)),
        torch.where(nz_theta, ((sigma - 1.0) * s + 1.0) / nz(sigma * sigma),
                    (a * sigma + (1.0 - b) * theta) / nz(theta * c)))
    B = torch.where(
        nz_sigma,
        torch.where(nz_theta, torch.full_like(theta, 1.0 / 6.0),
                    (theta - torch.sin(theta)) / nz(theta2 * theta)),
        torch.where(nz_theta,
                    (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0)
                    / nz(sigma * sigma * sigma),
                    ((s - 1.0) / nz(sigma) - ((b - 1.0) * sigma + a * theta)
                     / nz(c)) / nz(theta2)))
    C = torch.where(nz_sigma, torch.ones_like(sigma), (s - 1.0) / nz(sigma))
    W = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return (C[..., None, None] * eye + A[..., None, None] * W
            + B[..., None, None] * (W @ W))


def sim3_exp(xi: torch.Tensor) -> dict:
    """sim3 [..., 7] [rho, phi, sigma] -> Sim3."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_sim3_W(phi, sigma) @ rho[..., None])[..., 0]
    return {"R": so3_exp(phi), "t": t, "s": torch.exp(sigma)}


def sim3_log(S: dict) -> torch.Tensor:
    """Sim3 -> sim3 [..., 7]."""
    phi = so3_log(S["R"])
    sigma = torch.log(S["s"])
    rho = torch.linalg.solve(_sim3_W(phi, sigma), S["t"][..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)
