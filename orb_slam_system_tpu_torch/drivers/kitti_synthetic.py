"""KITTI-00-scale drive for the port (the JAX package's
examples/kitti_synthetic.py): a long monocular drive of straights, 90-degree
turns and same-direction revisits through the pipelined mode.

    python -m orb_slam_system_tpu_torch.drivers.kitti_synthetic \\
        [n_frames] [out_dir] [--laps L] [--async-mapping] \\
        [--device cuda|cpu]

The camera rides a rounded-rectangle "city block" circuit (36 x 18 m,
3 m corners, ~102.8 m a lap) with a car-like tangent heading, 2 m above
the textured ground and pitched down; the second lap revisits every street
in the same direction, so loops can close all along it. 4000 frames over 2
laps (the default, the reference artifact's scale) is ~5.1 cm a frame; a
shorter run keeps that pace with laps = 2 * n_frames / 4000. Keyframe
culling, the spanning-tree surgery and the trajectory export through
culled references (reference src/System.cc:398-451) run at length. With
an out_dir it writes CameraTrajectory.txt (KITTI 3x4 rows, one per frame
from initialization on), KeyFrameTrajectory.txt (TUM) and summary.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture)
from orb_slam_system_tpu_torch.drivers._driver_util import add_device_arg
from orb_slam_system_tpu_torch.drivers.mono_synthetic import make_config
from orb_slam_system_tpu_torch.models.system import System


def drive_trajectory(n_frames: int, width: float = 36.0,
                     height: float = 18.0, corner: float = 3.0,
                     laps: float = 2.0, depth: float = -2.0,
                     tilt: float = 0.3):
    """Rounded-rectangle circuit with tangent heading: a list of
    camera-from-world T (4x4), the camera at constant height |depth| over
    the ground plane, pitched down by `tilt`, yawed along the direction of
    travel."""
    w, h, c = width - 2 * corner, height - 2 * corner, corner
    seg_lens = [w, np.pi / 2 * c, h, np.pi / 2 * c,
                w, np.pi / 2 * c, h, np.pi / 2 * c]
    per = float(sum(seg_lens))
    starts = np.cumsum([0.0] + seg_lens)

    def point(s):
        """Position and heading at arclength s along one lap (counter-
        clockwise from the bottom-left end of the bottom straight)."""
        s = s % per
        i = int(np.searchsorted(starts[1:], s, side="right"))
        t = s - starts[i]
        x0, y0 = -w / 2, -height / 2
        x1, y1 = w / 2, height / 2
        if i == 0:    # bottom, +x
            return np.array([x0 + t, y0]), 0.0
        if i == 1:    # corner bottom-right
            a = t / c
            ctr = np.array([x1, y0 + c])
            return ctr + c * np.array([np.sin(a), -np.cos(a)]), a
        if i == 2:    # right, +y
            return np.array([x1 + c, y0 + c + t]), np.pi / 2
        if i == 3:
            a = t / c
            ctr = np.array([x1, y1 - c])
            return ctr + c * np.array([np.cos(a), np.sin(a)]), np.pi / 2 + a
        if i == 4:    # top, -x, at y1: the top-right arc ends at (x1, y1)
            # and the top-left one starts at (x0, y1) (an anchor at y1 + c
            # would move the camera 3 m at both ends of the straight)
            return np.array([x1 - t, y1]), np.pi
        if i == 5:
            a = t / c
            ctr = np.array([x0, y1 - c])
            return ctr + c * np.array([-np.sin(a), np.cos(a)]), np.pi + a
        if i == 6:    # left, -y
            return np.array([x0 - c, y1 - c - t]), 3 * np.pi / 2
        a = t / c
        ctr = np.array([x0, y0 + c])
        return ctr + c * np.array([-np.cos(a), -np.sin(a)]), 3 * np.pi / 2 + a

    ct, st_ = np.cos(tilt), np.sin(tilt)
    R_tilt = np.array([[1.0, 0.0, 0.0], [0.0, ct, -st_], [0.0, st_, ct]])
    total = laps * per
    poses = []
    for i in range(n_frames):
        xy, th = point(total * i / n_frames)
        # Yaw about the plane's normal (world z), then the fixed pitch.
        cz, sz = np.cos(th), np.sin(th)
        R_yaw = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
        R_cw = R_tilt.T @ R_yaw.T
        C = np.array([xy[0], xy[1], depth])
        T = np.eye(4)
        T[:3, :3] = R_cw
        T[:3, 3] = -R_cw @ C
        poses.append(T)
    return poses


def run(n_frames=4000, out_dir=None, verbose=True, n_features=400,
        async_mapping=False, laps=2.0, device="cuda"):
    """Drive the circuit at 320x240 through
    System.track_monocular_pipelined. Returns (system, summary dict)."""
    cfg = make_config(n_features=n_features)
    # The circuit spans ~40 m: the texture covers it without clamping.
    r = PlanarSceneRenderer(cfg.camera.K, cfg.camera.width, cfg.camera.height,
                            texture=make_texture(size=8192, block=8, seed=11),
                            tex_scale=200.0)
    poses = drive_trajectory(n_frames, laps=laps)
    slam = System(cfg, device=device, async_mapping=async_mapping)
    gt = {}
    host_ms = []
    kf_counts = []
    t_start = time.perf_counter()

    def gen():
        for i, Tcw in enumerate(poses):
            ts = i / 30.0
            gt[ts] = (-Tcw[:3, :3].T @ Tcw[:3, 3]).astype(np.float64)
            yield r.render(Tcw), ts

    t0 = time.perf_counter()
    for i, _ in enumerate(slam.track_monocular_pipelined(gen())):
        host_ms.append((time.perf_counter() - t0) * 1e3)
        kf_counts.append(slam.arena.n_keyframes())
        if verbose and i % 100 == 0:
            print(f"frame {i:5d} {slam.get_tracking_state().name:16s} "
                  f"kfs={kf_counts[-1]:4d} mps={slam.arena.n_points():5d} "
                  f"loops={slam.loop_closer.n_loops_closed} "
                  f"host={host_ms[-1]:.0f}ms", flush=True)
        t0 = time.perf_counter()
    slam.shutdown()
    wall_s = time.perf_counter() - t_start
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    rmse = traj_io.ate_rmse(est, gt)
    n_tracked = sum(1 for _, _, lost in est if not lost)
    third = max(n_frames // 3, 1)
    med = lambda xs: float(np.median(xs)) if len(xs) else 0.0  # noqa: E731
    summary = {
        "n_frames": n_frames,
        "n_tracked": n_tracked,
        "n_keyframes_final": slam.arena.n_keyframes(),
        "n_keyframes_peak": int(max(kf_counts)) if kf_counts else 0,
        "n_points_final": slam.arena.n_points(),
        "loops_closed": slam.loop_closer.n_loops_closed,
        "ate_rmse_m": float(rmse),
        "wall_s": wall_s,
        "host_ms_median_thirds": [med(host_ms[:third]),
                                  med(host_ms[third:2 * third]),
                                  med(host_ms[2 * third:])],
        "loop_stats": dict(slam.loop_closer.stats),
        "chain_stats": dict(slam.tracker.chain_stats),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        # The reference artifact's export: KITTI 3x4 rows, one per frame,
        # through culled references (src/System.cc:398-451).
        slam.save_trajectory_kitti(os.path.join(out_dir,
                                                "CameraTrajectory.txt"))
        slam.save_keyframe_trajectory_tum(
            os.path.join(out_dir, "KeyFrameTrajectory.txt"))
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return slam, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=4000)
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--laps", type=float, default=2.0,
                    help="laps of the circuit (2 * n_frames / 4000 keeps "
                         "the full drive's ~5.1 cm a frame)")
    ap.add_argument("--async-mapping", action="store_true")
    add_device_arg(ap)
    a = ap.parse_args(argv)
    run(a.n_frames, a.out_dir, async_mapping=a.async_mapping, laps=a.laps,
        device=a.device)


if __name__ == "__main__":
    main()
