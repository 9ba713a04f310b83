"""Stereo EuRoC driver with on-the-fly rectification (reference
Examples/Stereo/stereo_euroc.cc:39-187; the JAX package's
examples/stereo_euroc.py).

    python -m orb_slam_system_tpu_torch.drivers.stereo_euroc \\
        path_to_vocabulary path_to_settings path_to_cam0_dir \\
        path_to_cam1_dir path_to_timestamp_file [--no-realtime] \\
        [--device cuda|cpu] [--out-dir DIR]

The settings yaml must carry LEFT/RIGHT.{K,D,R,P} blocks (reference
:60-98); images are rectified on the host with precomputed remap grids
(numpy, as in the JAX package) before tracking, and a TUM-format
CameraTrajectory.txt is written (:187).
"""

from __future__ import annotations

import sys

import numpy as np

from orb_slam_system_tpu_torch.config import Sensor, load_settings
from orb_slam_system_tpu_torch.dataio.datasets import load_euroc
from orb_slam_system_tpu_torch.drivers._driver_util import (
    make_fetcher, out_path, parse_args, print_timing_report, track_sequence)
from orb_slam_system_tpu_torch.models.system import System


def build_rectify_map(K, D, R, P, width, height):
    """cv::initUndistortRectifyMap equivalent: for each rectified pixel,
    the source (distorted) pixel to sample. Returns (map_x, map_y)."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    # Rectified pixel -> normalized coords in rectified frame.
    fx_p, fy_p, cx_p, cy_p = P[0, 0], P[1, 1], P[0, 2], P[1, 2]
    x = (u - cx_p) / fx_p
    y = (v - cy_p) / fy_p
    ones = np.ones_like(x)
    pts = np.stack([x, y, ones], axis=-1)          # [H,W,3]
    # Rotate back into the original camera frame.
    pts = pts @ R  # (R^T applied to rows) -- R maps original->rectified
    x0 = pts[..., 0] / pts[..., 2]
    y0 = pts[..., 1] / pts[..., 2]
    # Apply distortion (k1,k2,p1,p2[,k3]).
    k1, k2, p1, p2 = D.flatten()[:4]
    k3 = D.flatten()[4] if D.size > 4 else 0.0
    r2 = x0 * x0 + y0 * y0
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x0 * radial + 2 * p1 * x0 * y0 + p2 * (r2 + 2 * x0 * x0)
    yd = y0 * radial + p1 * (r2 + 2 * y0 * y0) + 2 * p2 * x0 * y0
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return (xd * fx + cx).astype(np.float32), (yd * fy + cy).astype(np.float32)


def remap_bilinear(img, map_x, map_y):
    h, w = img.shape
    x0 = np.clip(np.floor(map_x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(map_y).astype(np.int64), 0, h - 2)
    fx = np.clip(map_x - x0, 0, 1)
    fy = np.clip(map_y - y0, 0, 1)
    out = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
           + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    oob = (map_x < 0) | (map_x >= w - 1) | (map_y < 0) | (map_y >= h - 1)
    return np.where(oob, 0.0, out).astype(np.float32)


def main(argv=None) -> int:
    args = parse_args(__doc__, ["path_to_vocabulary", "path_to_settings",
                                "path_to_cam0_dir", "path_to_cam1_dir",
                                "path_to_timestamp_file"], argv)
    cfg = load_settings(args.path_to_settings, Sensor.STEREO)
    if cfg.rect_left is None or cfg.rect_right is None:
        print("ERROR: settings lack LEFT/RIGHT rectification blocks")
        return 1
    W, H = cfg.camera.width, cfg.camera.height
    maps = [build_rectify_map(r["K"], r["D"], r["R"], r["P"], W, H)
            for r in (cfg.rect_left, cfg.rect_right)]
    paths0, times = load_euroc(args.path_to_cam0_dir,
                               args.path_to_timestamp_file)
    paths1, _ = load_euroc(args.path_to_cam1_dir, args.path_to_timestamp_file)
    print(f"Images in the sequence: {len(paths0)}")
    slam = System(cfg, Sensor.STEREO, device=args.device,
                  vocabulary_path=args.vocabulary)
    with make_fetcher(paths0) as cam0, make_fetcher(paths1) as cam1:
        track_times = track_sequence(
            times, lambda i: (remap_bilinear(cam0.fetch(i), *maps[0]),
                              remap_bilinear(cam1.fetch(i), *maps[1])),
            slam.track_stereo, not args.no_realtime)
    slam.shutdown()
    print_timing_report(track_times)
    slam.save_trajectory_tum(out_path(args, "CameraTrajectory.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
