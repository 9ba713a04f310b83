"""Plain numpy geometry the program's poses and map are judged by: the
similarity alignment of a monocular trajectory to the rendered one, the
relative step error, the map's reprojection residuals in its keyframes and
its points' distance from the rendered ground plane."""

from __future__ import annotations

import numpy as np


def centre(Tcw: np.ndarray) -> np.ndarray:
    T = np.asarray(Tcw, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def umeyama(est: np.ndarray, gt: np.ndarray):
    """(s, R, t) minimizing |gt - (s R est + t)|^2 over points [n, 3]
    (Umeyama 1991)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (E ** 2).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / var) if var > 0 else 1.0
    return s, R, mu_g - s * R @ mu_e


def step_error(est: np.ndarray, gt: np.ndarray, steps) -> tuple:
    """(sum of |aligned estimated step - true step|, sum of |true step|)
    over the index pairs `steps`, with est aligned to gt by a similarity
    fitted on all the rows."""
    s, R, _t = umeyama(est, gt)
    err = tot = 0.0
    for i, j in steps:
        d_est = s * R @ (est[j] - est[i])
        d_gt = gt[j] - gt[i]
        err += float(np.linalg.norm(d_est - d_gt))
        tot += float(np.linalg.norm(d_gt))
    return err, tot


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    s, R, t = umeyama(est, gt)
    return float(np.sqrt((((s * est @ R.T + t) - gt) ** 2).sum(1).mean()))


def reprojection_chi2(K: np.ndarray, Tcw: np.ndarray, points: np.ndarray,
                      uv: np.ndarray, octave: np.ndarray, scale: float):
    """Per observation |uv - project(Tcw points)|^2 / sigma^2 with ORB-SLAM2's
    sigma = scale^octave pixels; behind-camera points read inf."""
    Xc = points @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = Xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = K[0, 0] * Xc[:, 0] / z + K[0, 2]
        v = K[1, 1] * Xc[:, 1] / z + K[1, 2]
    r2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    chi2 = r2 / (scale ** (2.0 * octave))
    return np.where(z > 0, chi2, np.inf)


def planarity(points: np.ndarray, centres: np.ndarray) -> float:
    """Median distance of points from the plane fitted to them (least
    squares, refitted once without the tenth farthest), per the median
    distance of the camera centres from that plane."""
    keep = np.ones(len(points), bool)
    for _ in range(2):
        mu = points[keep].mean(0)
        n = np.linalg.svd(points[keep] - mu)[2][2]
        d = np.abs((points - mu) @ n)
        keep = d <= np.quantile(d, 0.9)
    return float(np.median(d) / np.median(np.abs((centres - mu) @ n)))


def bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (round to nearest even) and back: the control
    puts the reference in the program's place one precision lower."""
    import torch
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16
                                                         ).to(torch.float64).numpy()
