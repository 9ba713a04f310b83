"""SO3 / SE3 operations on torch tensors (the part of the JAX package's
utils/lie.py the tracking step needs; the rest ports later).

Conventions as in the JAX package: rotations are 3x3, transforms Tcw are 4x4
[R t; 0 1], se3 tangents are [rho(3), phi(3)] (translation first).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 hat operator: w (3,) -> skew-symmetric (3,3)."""
    z = torch.zeros_like(w[0])
    return torch.stack([
        torch.stack([z, -w[2], w[1]]),
        torch.stack([w[2], z, -w[0]]),
        torch.stack([-w[1], w[0], z]),
    ])


def _coeffs(w: torch.Tensor):
    """Rodrigues coefficients A = sin t / t, B = (1 - cos t) / t^2,
    C = (t - sin t) / t^3, with Taylor guards near t = 0."""
    theta2 = torch.dot(w, w)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    t2s = torch.where(big, theta2, torch.ones_like(theta2))
    A = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    B = torch.where(big, (1.0 - torch.cos(theta)) / t2s, 0.5 - theta2 / 24.0)
    C = torch.where(big, (theta - torch.sin(theta)) / (t2s * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, numerically safe near theta = 0."""
    A, B, _ = _coeffs(w)
    W = hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * W + B * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 (6,) [rho, phi] -> SE3 (4,4)."""
    rho, phi = xi[:3], xi[3:6]
    A, B, C = _coeffs(phi)
    W = hat(phi)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A * W + B * WW
    V = eye + B * W + C * WW
    top = torch.cat([R, (V @ rho)[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=xi.dtype,
                          device=xi.device)
    return torch.cat([top, bottom], dim=0)


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
