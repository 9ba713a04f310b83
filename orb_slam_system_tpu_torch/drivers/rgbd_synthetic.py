"""Synthetic RGB-D driver for the port: the System over rendered images of
the textured-plane orbit with their analytic depth maps, TUM-style 16-bit
scaling (depth x DepthMapFactor 5000), and known ground truth (the RGB-D
run of the JAX package's tests/test_e2e_rgbd.py). The map is seeded from
the first frame's depths at metric scale. Optionally it then turns on
localization mode, wipes the last frame's map associations and tracks
`localize` more frames of the orbit on temporary visual-odometry points.

    python -m orb_slam_system_tpu_torch.drivers.rgbd_synthetic \\
        [n_frames] [out_dir] [--cpu] [--features N] [--localize K] \\
        [--pipelined] [--async-mapping]

The camera is the JAX test's: 320x240, fx = fy = 260, bf = 260 x 0.08,
th_depth 40 m, texture scale 220; the orbit has n_frames + K poses.
Prints the frames tracked, the SE3-aligned ATE RMSE and the travelled span
against the truth, and writes CameraTrajectory.txt (TUM format).
--pipelined tracks the mapping frames through System.track_rgbd_pipelined
(depth 2), --async-mapping runs the local mapper on its worker thread.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig, Sensor,
                                              SlamConfig, TrackingState)
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.drivers.stereo_synthetic import metric_span
from orb_slam_system_tpu_torch.models.system import System

DEPTH_MAP_FACTOR = 5000.0   # TUM's 16-bit depth scaling


def make_config(width=320, height=240, n_features=500) -> SlamConfig:
    cam = CameraConfig(fx=260.0, fy=260.0, cx=width / 2, cy=height / 2,
                       fps=30.0, width=width, height=height, bf=260.0 * 0.08)
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=n_features),
                      sensor=Sensor.RGBD, th_depth=40.0,
                      depth_map_factor=DEPTH_MAP_FACTOR)


def run(n_frames=20, out_dir: Optional[str] = ".", n_features=500,
        device="cuda", verbose=True, cfg: Optional[SlamConfig] = None,
        tex_scale: float = 220.0, localize: int = 0, pipelined=False,
        async_mapping=False):
    """Track n_frames through System.track_rgbd, then (localize > 0)
    localization mode with the last frame's map associations wiped for
    `localize` more frames. cfg: the camera, make_config(n_features=...)
    by default; out_dir None writes no files. Returns (system, SE3-aligned
    ATE RMSE in m over the mapping frames, span, true span, the states of
    the localization frames, whether any of them carried VO points)."""
    cfg = make_config(n_features=n_features) if cfg is None else cfg
    cam = cfg.camera
    r = PlanarSceneRenderer(cam.K, cam.width, cam.height,
                            texture=make_texture(size=2048, block=8, seed=7),
                            tex_scale=tex_scale)
    poses = orbit_trajectory(n_frames + localize, radius=0.35, depth=-2.0,
                             tilt=0.3)
    slam = System(cfg, Sensor.RGBD, device=device, async_mapping=async_mapping)
    gt, loc_states, vo_used = {}, [], False

    def item(i):
        return (r.render(poses[i]),
                r.render_depth(poses[i]) * cfg.depth_map_factor, i / 30.0)

    def report(i):
        if verbose:
            rec = slam.telemetry.records[-1]
            print(f"frame {i:3d} state={slam.get_tracking_state().name:16s} "
                  f"tracked={rec['n_tracked']:4d} kfs={rec['n_kfs']} "
                  f"mps={rec['n_mps']} vo={len(slam.tracker.current.vo_points or ())} "
                  f"track={rec['track_ms']:.1f} ms "
                  f"mapping={rec['mapping_ms']:.1f} ms", flush=True)

    items = (item(i) for i in range(n_frames))
    track = (slam.track_rgbd_pipelined(items) if pipelined
             else (slam.track_rgbd(*it) for it in items))
    for i, _ in enumerate(track):
        report(i)
        gt[i / 30.0] = (-poses[i][:3, :3].T @ poses[i][:3, 3]).astype(np.float64)
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    rmse = traj_io.ate_rmse(est, gt, with_scale=False)   # metric: SE3 only
    span, span_gt = metric_span(est, gt)
    if localize:
        slam.activate_localization_mode()
        slam.tracker.last_frame.mp_ids[:] = -1   # the map goes out of view
        for i in range(n_frames, n_frames + localize):
            slam.track_rgbd(*item(i))
            report(i)
            loc_states.append(slam.get_tracking_state() == TrackingState.OK)
            vo_used = vo_used or bool(slam.tracker.current.vo_points)
    slam.shutdown()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        slam.save_trajectory_tum(os.path.join(out_dir, "CameraTrajectory.txt"))
    if verbose:
        print(f"frames tracked: {sum(1 for *_, lost in est if not lost)}"
              f"/{n_frames}")
        print(f"ATE RMSE (SE3-aligned): {rmse * 100:.2f} cm | metric span "
              f"est/gt = {span:.3f}/{span_gt:.3f}")
        if localize:
            print(f"localization mode: {sum(loc_states)}/{localize} frames OK, "
                  f"VO points used: {vo_used}")
    return slam, rmse, span, span_gt, loc_states, vo_used


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=20)
    ap.add_argument("out_dir", nargs="?", default=".")
    ap.add_argument("--features", type=int, default=500)
    ap.add_argument("--localize", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch paths, no kernels)")
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--async-mapping", action="store_true")
    a = ap.parse_args()
    run(a.n_frames, a.out_dir, a.features, "cpu" if a.cpu else "cuda",
        localize=a.localize, pipelined=a.pipelined,
        async_mapping=a.async_mapping)


if __name__ == "__main__":
    main()
