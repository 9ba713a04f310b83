"""TUM-benchmark-compatible trajectory evaluation (ATE + RPE); a copy of
the JAX package's tools/evaluate_ate.py for the port.

The reference validates exclusively by running dataset drivers and
evaluating the written trajectory offline against ground truth with the
TUM benchmark scripts (SURVEY.md §4; Examples/Monocular/mono_tum.cc:111-123
prints timings and writes KeyFrameTrajectory.txt for exactly this purpose).
Those scripts are external tooling the reference never ships; this CLI fills
the gap so that the moment a real dataset (TUM fr1_xyz, KITTI 00, ...) is
available, the validation gate is one command:

    python -m orb_slam_system_tpu_torch.drivers.evaluate_ate \\
        groundtruth.txt KeyFrameTrajectory.txt

Compatible with the TUM RGB-D benchmark `evaluate_ate.py` /
`evaluate_rpe.py` conventions:
  * TUM file format: `timestamp tx ty tz qx qy qz qw`, '#' comments
    (matches the reference's SaveTrajectoryTUM output, src/System.cc:355).
  * Timestamp association with --max_difference (default 0.02 s) and
    --offset.
  * ATE: SE3 Umeyama alignment (add --scale for Sim3 — monocular
    trajectories are defined only up to scale) then translational RMSE.
  * RPE: relative pose error over --delta frames (default 1), reporting
    translational and rotational errors.
KITTI-format files (12 values per line, 3x4 row-major Twc, the
reference's SaveTrajectoryKITTI format src/System.cc:445-447) are
auto-detected and associated by line index, unless --gt_times gives the
sequence's times.txt: then the ground truth's i-th pose takes line i's
seconds, so it associates with a TUM-format estimate stamped from the same
file (a monocular KITTI run's KeyFrameTrajectory.txt).

Pure numpy — runs anywhere, no device needed.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


# ---------------------------------------------------------------------------
# File loading
# ---------------------------------------------------------------------------

def load_times(path: str) -> list[float]:
    """A KITTI times.txt: one timestamp [s] per line."""
    with open(path) as f:
        return [float(line) for line in f if line.strip()]


def load_trajectory(path: str, times=None) -> dict[float, np.ndarray]:
    """Returns {timestamp: Twc 4x4}. Auto-detects TUM (8 cols: t xyz quat)
    vs KITTI (12 cols: 3x4 Twc, timestamp = line index, or times[line
    index] when `times` is given)."""
    poses: dict[float, np.ndarray] = {}
    idx = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) == 12:
                T = np.eye(4)
                T[:3, :] = np.asarray(vals).reshape(3, 4)
                poses[float(idx) if times is None else times[idx]] = T
                idx += 1
            elif len(vals) >= 8:
                t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
                T = np.eye(4)
                T[:3, :3] = _rot_from_quat(qx, qy, qz, qw)
                T[:3, 3] = (tx, ty, tz)
                poses[t] = T
            elif len(vals) == 4:          # timestamp tx ty tz (position-only gt)
                t, tx, ty, tz = vals
                T = np.eye(4)
                T[:3, 3] = (tx, ty, tz)
                poses[t] = T
            else:
                raise ValueError(
                    f"{path}: unrecognized row with {len(vals)} columns")
    if not poses:
        raise ValueError(f"{path}: no poses loaded")
    return poses


def _rot_from_quat(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    if n == 0:
        return np.eye(3)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])


# ---------------------------------------------------------------------------
# Association (TUM associate.py semantics: greedy best-pair by |dt|)
# ---------------------------------------------------------------------------

def associate(gt: dict, est: dict, offset: float, max_difference: float):
    pairs = []
    for te in est:
        cand = [(abs(tg - (te + offset)), tg) for tg in gt
                if abs(tg - (te + offset)) <= max_difference]
        if cand:
            pairs.append((min(cand)[1], te))
    # Greedy de-duplication: each gt timestamp used once (best |dt| wins).
    pairs.sort(key=lambda p: abs(p[0] - (p[1] + offset)))
    used_gt, used_est, out = set(), set(), []
    for tg, te in pairs:
        if tg in used_gt or te in used_est:
            continue
        used_gt.add(tg)
        used_est.add(te)
        out.append((tg, te))
    out.sort()
    return out


# ---------------------------------------------------------------------------
# ATE
# ---------------------------------------------------------------------------

def umeyama(P: np.ndarray, Q: np.ndarray, with_scale: bool):
    """Least-squares similarity transform mapping P onto Q (Umeyama 1991).
    Returns (s, R, t) with Q ≈ s·R·P + t."""
    mu_p, mu_q = P.mean(0), Q.mean(0)
    Pc, Qc = P - mu_p, Q - mu_q
    cov = Qc.T @ Pc / len(P)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_p = (Pc ** 2).sum() / len(P)
        s = float(np.trace(np.diag(D) @ S) / var_p) if var_p > 0 else 1.0
    else:
        s = 1.0
    t = mu_q - s * R @ mu_p
    return s, R, t


def ate(gt: dict, est: dict, pairs, with_scale: bool):
    P = np.stack([est[te][:3, 3] for _, te in pairs])
    Q = np.stack([gt[tg][:3, 3] for tg, _ in pairs])
    s, R, t = umeyama(P, Q, with_scale)
    err = (s * (R @ P.T).T + t) - Q
    d = np.linalg.norm(err, axis=1)
    return {
        "compared_pose_pairs": len(pairs),
        "absolute_translational_error.rmse": float(np.sqrt((d ** 2).mean())),
        "absolute_translational_error.mean": float(d.mean()),
        "absolute_translational_error.median": float(np.median(d)),
        "absolute_translational_error.std": float(d.std()),
        "absolute_translational_error.min": float(d.min()),
        "absolute_translational_error.max": float(d.max()),
        "alignment_scale": s,
    }


# ---------------------------------------------------------------------------
# RPE
# ---------------------------------------------------------------------------

def rpe(gt: dict, est: dict, pairs, delta: int):
    dt_list, dr_list = [], []
    for i in range(len(pairs) - delta):
        tg0, te0 = pairs[i]
        tg1, te1 = pairs[i + delta]
        E = (np.linalg.inv(np.linalg.inv(gt[tg0]) @ gt[tg1])
             @ (np.linalg.inv(est[te0]) @ est[te1]))
        dt_list.append(np.linalg.norm(E[:3, 3]))
        ang = np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        dr_list.append(np.degrees(np.arccos(ang)))
    if not dt_list:
        return {}
    dt = np.asarray(dt_list)
    dr = np.asarray(dr_list)
    return {
        "compared_relpose_pairs": len(dt),
        "translational_error.rmse": float(np.sqrt((dt ** 2).mean())),
        "translational_error.mean": float(dt.mean()),
        "translational_error.median": float(np.median(dt)),
        "rotational_error.rmse_deg": float(np.sqrt((dr ** 2).mean())),
        "rotational_error.mean_deg": float(dr.mean()),
        "rotational_error.median_deg": float(np.median(dr)),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="ATE/RPE evaluation (TUM benchmark conventions)")
    ap.add_argument("groundtruth", help="gt trajectory (TUM or KITTI format)")
    ap.add_argument("estimate", help="estimated trajectory (TUM or KITTI)")
    ap.add_argument("--offset", type=float, default=0.0,
                    help="time offset added to estimate timestamps")
    ap.add_argument("--max_difference", type=float, default=0.02,
                    help="max timestamp difference for association [s]")
    ap.add_argument("--scale", action="store_true",
                    help="align with scale (Sim3) — use for monocular")
    ap.add_argument("--delta", type=int, default=1,
                    help="RPE frame delta (associated-pair steps)")
    ap.add_argument("--no-rpe", action="store_true", help="skip RPE")
    ap.add_argument("--max_ate", type=float, default=None,
                    help="exit nonzero if ATE RMSE exceeds this gate [m]")
    ap.add_argument("--gt_times", default=None,
                    help="times.txt stamping a KITTI-format ground truth")
    args = ap.parse_args(argv)

    gt = load_trajectory(args.groundtruth, None if args.gt_times is None
                         else load_times(args.gt_times))
    est = load_trajectory(args.estimate)
    pairs = associate(gt, est, args.offset, args.max_difference)
    if len(pairs) < 3:
        print(f"error: only {len(pairs)} associated pairs "
              f"(gt={len(gt)} est={len(est)}) — check --max_difference/"
              f"--offset", file=sys.stderr)
        return 2

    stats = ate(gt, est, pairs, args.scale)
    if not args.no_rpe:
        stats.update(rpe(gt, est, pairs, args.delta))
    for k, v in stats.items():
        print(f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}")

    if args.max_ate is not None:
        rmse = stats["absolute_translational_error.rmse"]
        ok = rmse <= args.max_ate
        print(f"gate {'PASS' if ok else 'FAIL'} "
              f"(rmse {rmse:.4f} {'<=' if ok else '>'} {args.max_ate})")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
