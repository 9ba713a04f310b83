"""Synthetic monocular driver for the port: the full System over a rendered
orbit with known ground truth (the JAX package's examples/mono_synthetic.py,
the hermetic analogue of the reference's mono_tum). Prints per-frame state,
map size and time, writes KeyFrameTrajectory.txt / CameraTrajectory.txt /
CameraTrajectoryKITTI.txt and reports the Sim3-aligned ATE RMSE.

    python -m orb_slam_system_tpu_torch.drivers.mono_synthetic \\
        [n_frames] [out_dir] [--cpu] [--width W --height H --features N] \\
        [--pipelined] [--async-mapping]

--pipelined tracks through System.track_monocular_pipelined (depth 2),
--async-mapping runs the local mapper on its worker thread.

The camera scales with the width: fx = fy = 260 * width / 320 and the
texture scale 220 * width / 320 (320x240 is the JAX example's size, 640x480
the reference's TUM1 front end).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig, Sensor,
                                              SlamConfig)
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.models.system import System


def make_config(width=320, height=240, n_features=500) -> SlamConfig:
    f = 260.0 * width / 320
    cam = CameraConfig(fx=f, fy=f, cx=width / 2, cy=height / 2, fps=30.0,
                       width=width, height=height)
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=n_features),
                      sensor=Sensor.MONOCULAR)


def make_renderer(cfg: SlamConfig) -> PlanarSceneRenderer:
    """The textured plane, seen through cfg's camera."""
    cam = cfg.camera
    return PlanarSceneRenderer(cam.K, cam.width, cam.height,
                               texture=make_texture(size=2048, block=8, seed=7),
                               tex_scale=220.0 * cam.width / 320)


def render_sequence(cfg: SlamConfig, n_frames: int):
    """(frames f32[H,W] list, true Tcw list) of the orbit."""
    renderer = make_renderer(cfg)
    poses = orbit_trajectory(n_frames, radius=0.35, depth=-2.0, tilt=0.3)
    return [renderer.render(T) for T in poses], poses


def track_frames(slam, items, pipelined: bool):
    """Feed (img, timestamp) items to the System: through
    track_monocular_pipelined, or track_monocular frame by frame. Yields
    Tcw (or None) per frame, in order."""
    if pipelined:
        return slam.track_monocular_pipelined(items)
    return (slam.track_monocular(img, ts) for img, ts in items)


def run(n_frames=80, out_dir=".", n_features=500, width=320, height=240,
        device="cuda", verbose=True, pipelined=False, async_mapping=False):
    """Track the orbit through System.track_monocular (or, pipelined,
    track_monocular_pipelined); out_dir None writes no files. Returns
    (system, ATE RMSE in m)."""
    cfg = make_config(width, height, n_features)
    frames, poses = render_sequence(cfg, n_frames)
    slam = System(cfg, Sensor.MONOCULAR, device=device,
                  async_mapping=async_mapping)
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}
    items = ((img, i / 30.0) for i, img in enumerate(frames))
    for i, _ in enumerate(track_frames(slam, items, pipelined)):
        if verbose:
            r = slam.telemetry.records[-1]
            print(f"frame {i:3d} state={slam.get_tracking_state().name:16s} "
                  f"tracked={r['n_tracked']:4d} kfs={r['n_kfs']} "
                  f"mps={r['n_mps']} track={r['track_ms']:.1f} ms "
                  f"mapping={r['mapping_ms']:.1f} ms", flush=True)
    slam.shutdown()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        slam.save_keyframe_trajectory_tum(
            os.path.join(out_dir, "KeyFrameTrajectory.txt"))
        slam.save_trajectory_tum(os.path.join(out_dir, "CameraTrajectory.txt"))
        slam.save_trajectory_kitti(
            os.path.join(out_dir, "CameraTrajectoryKITTI.txt"))
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    rmse = traj_io.ate_rmse(est, gt)
    if verbose:
        rep = slam.timing_report()
        print(f"median time per frame: {rep['median_s'] * 1e3:.1f} ms, mean "
              f"{rep['mean_s'] * 1e3:.1f} ms ({slam.device})")
        print(f"frames tracked: {sum(1 for _, _, lost in est if not lost)}"
              f"/{n_frames}")
        print(f"ATE RMSE (Sim3-aligned): {rmse * 100:.2f} cm")
    return slam, rmse


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=80)
    ap.add_argument("out_dir", nargs="?", default=".")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--features", type=int, default=500)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch paths, no kernels)")
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--async-mapping", action="store_true")
    a = ap.parse_args()
    run(a.n_frames, a.out_dir, a.features, a.width, a.height,
        "cpu" if a.cpu else "cuda", pipelined=a.pipelined,
        async_mapping=a.async_mapping)


if __name__ == "__main__":
    main()
