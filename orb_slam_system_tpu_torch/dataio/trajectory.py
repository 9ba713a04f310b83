"""Trajectory export in the reference's file formats.

Copy of orb_slam_system_tpu/dataio/trajectory.py; the quaternion comes
from the numpy utils.lie.quat_from_rot.

Formats preserved bit-compatibly in structure (SURVEY.md §7.4):
  * TUM:   `timestamp tx ty tz qx qy qz qw` (reference src/System.cc:301-359)
  * KITTI: 3x4 row-major Twc per line (src/System.cc:398-451)
  * KeyFrame TUM: keyframe poses only (src/System.cc:362-396)
The per-frame pose is reconstructed as Tcw = Tcr * [spanning-tree walk past
culled keyframes via Tcp] * Tkf * Two, exactly the reference's scheme.
"""

from __future__ import annotations

import numpy as np

from orb_slam_system_tpu_torch.mapping.arena import MapArena
from orb_slam_system_tpu_torch.utils import lie


def _quat_np(R: np.ndarray) -> np.ndarray:
    return lie.quat_from_rot(R)


def _resolve_ref_pose(arena: MapArena, ref_kf_id: int):
    """Walk the spanning tree past culled keyframes (reference
    src/System.cc:341-345): returns (T_extra, live_kf) with
    Tcw_ref_effective = T_extra @ live_kf.Tcw."""
    T_extra = np.eye(4, dtype=np.float32)
    kf_id = ref_kf_id
    for _ in range(1000):
        if kf_id in arena.kfs:
            return T_extra, arena.kfs[kf_id]
        dead = arena.dead_kfs.get(kf_id)
        if dead is None or dead.Tcp is None or dead.parent < 0:
            return None, None
        T_extra = T_extra @ dead.Tcp
        kf_id = dead.parent
    return None, None


def frame_poses(arena: MapArena, trajectory) -> list:
    """Per-frame absolute Tcw from the relative-pose log. Returns list of
    (timestamp, Tcw, lost)."""
    if arena.kf_origin_id not in arena.kfs:
        return []
    Two = np.linalg.inv(arena.kfs[arena.kf_origin_id].Tcw)
    out = []
    for e in trajectory:
        T_extra, ref = _resolve_ref_pose(arena, e.ref_kf_id)
        if ref is None:
            continue
        Trw = T_extra @ ref.Tcw @ Two
        Tcw = e.Tcr @ Trw
        out.append((e.timestamp, Tcw, e.lost))
    return out


def save_trajectory_tum(path: str, arena: MapArena, trajectory):
    """Reference SaveTrajectoryTUM (src/System.cc:301-359)."""
    with open(path, "w") as f:
        for ts, Tcw, lost in frame_poses(arena, trajectory):
            R = Tcw[:3, :3]
            t = Tcw[:3, 3]
            Rwc = R.T
            twc = -Rwc @ t
            q = _quat_np(Rwc)
            f.write(
                f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_keyframe_trajectory_tum(path: str, arena: MapArena):
    """Reference SaveKeyFrameTrajectoryTUM (src/System.cc:362-396)."""
    with open(path, "w") as f:
        for kf_id in sorted(arena.kfs):
            kf = arena.kfs[kf_id]
            R = kf.Tcw[:3, :3]
            t = kf.Tcw[:3, 3]
            Rwc = R.T
            twc = -Rwc @ t
            q = _quat_np(Rwc)
            f.write(
                f"{kf.timestamp:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_trajectory_kitti(path: str, arena: MapArena, trajectory):
    """Reference SaveTrajectoryKITTI (src/System.cc:398-451)."""
    with open(path, "w") as f:
        for _, Tcw, _ in frame_poses(arena, trajectory):
            R = Tcw[:3, :3]
            t = Tcw[:3, 3]
            Rwc = R.T
            twc = -Rwc @ t
            vals = [
                Rwc[0, 0], Rwc[0, 1], Rwc[0, 2], twc[0],
                Rwc[1, 0], Rwc[1, 1], Rwc[1, 2], twc[1],
                Rwc[2, 0], Rwc[2, 1], Rwc[2, 2], twc[2],
            ]
            f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")


def ate_rmse(est: list, gt: dict, align: bool = True,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment — the
    standard offline evaluation the reference defers to external tooling
    (SURVEY.md §4). with_scale=True fits a similarity (monocular
    trajectories are defined up to scale); with_scale=False fits SE3 only,
    which removes the arbitrary world-frame offset (a SLAM estimate's
    world frame is its first camera) while keeping metric-scale errors
    visible — the right gate for stereo/RGB-D."""
    pairs = []
    for ts, Tcw, lost in est:
        if lost:
            continue
        key = min(gt.keys(), key=lambda k: abs(k - ts))
        if abs(key - ts) > 0.05:
            continue
        Rwc = Tcw[:3, :3].T
        twc = -Rwc @ Tcw[:3, 3]
        gtw = gt[key]
        pairs.append((twc, gtw))
    if len(pairs) < 3:
        return float("inf")
    P = np.stack([p[0] for p in pairs])   # estimated positions
    Q = np.stack([p[1] for p in pairs])   # ground-truth positions
    if align:
        P = umeyama_align(P, Q, with_scale=with_scale)
    return float(np.sqrt(np.mean(np.sum((P - Q) ** 2, axis=1))))


def umeyama_align(P: np.ndarray, Q: np.ndarray,
                  with_scale: bool = True) -> np.ndarray:
    """Similarity alignment P -> Q (Umeyama 1991; with_scale=False fits
    rigid SE3 only, for metric stereo/RGB-D trajectories)."""
    mu_p = P.mean(0)
    mu_q = Q.mean(0)
    Pc = P - mu_p
    Qc = Q - mu_q
    cov = Qc.T @ Pc / len(P)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_p = (Pc ** 2).sum() / len(P)
        scale = np.trace(np.diag(D) @ S) / var_p if var_p > 0 else 1.0
    else:
        scale = 1.0
    return (scale * (R @ Pc.T)).T + mu_q
