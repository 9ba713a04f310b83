"""Synthetic stereo driver for the port: the System over rendered rectified
pairs of the textured-plane orbit with known ground truth (the JAX
package's examples/stereo_synthetic.py, the hermetic analogue of the
reference's stereo_kitti). The map is seeded from the first pair's depths,
so the trajectory comes out at metric scale: prints the frames tracked, the
SE3-aligned ATE RMSE and the travelled span against the truth, and writes
CameraTrajectory.txt (KITTI format) and KeyFrameTrajectory.txt.

    python -m orb_slam_system_tpu_torch.drivers.stereo_synthetic \\
        [n_frames] [out_dir] [--cpu] [--features N] \\
        [--settings kitti00-02.yaml --tex-scale 440] \\
        [--pipelined] [--async-mapping]

By default the camera is the JAX example's: 320x240, fx = fy = 260, a
0.12 m baseline, texture scale 220. --settings loads a reference settings
file for Sensor.STEREO instead (e.g. examples/settings/kitti00-02.yaml:
1241x376, bf 386.1448, 2000 features); the right camera sits bf / fx to
the right. --pipelined tracks through System.track_stereo_pipelined (depth
2), --async-mapping runs the local mapper on its worker thread.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig, Sensor,
                                              SlamConfig, load_settings)
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.models.system import System

BASELINE = 0.12  # metres


def make_config(width=320, height=240, n_features=500) -> SlamConfig:
    cam = CameraConfig(fx=260.0, fy=260.0, cx=width / 2, cy=height / 2,
                       fps=30.0, width=width, height=height,
                       bf=260.0 * BASELINE)
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=n_features),
                      sensor=Sensor.STEREO, th_depth=35.0)


def render_pairs(cfg: SlamConfig, n_frames: int, tex_scale: float = 220.0):
    """(rectified (left, right) pairs, true Tcw list) of the orbit, the
    right camera bf / fx to the right of the left one."""
    cam = cfg.camera
    r = PlanarSceneRenderer(cam.K, cam.width, cam.height,
                            texture=make_texture(size=2048, block=8, seed=7),
                            tex_scale=tex_scale)
    poses = orbit_trajectory(n_frames, radius=0.35, depth=-2.0, tilt=0.3)
    return [r.render_stereo(T, cam.bf / cam.fx) for T in poses], poses


def metric_span(est, gt):
    """(travelled span of the tracked trajectory, the truth's): first to last
    camera centre, unaligned, in metres."""
    pos = [(-T[:3, :3].T @ T[:3, 3]) for _, T, lost in est if not lost]
    span = float(np.linalg.norm(pos[-1] - pos[0])) if len(pos) > 2 else 0.0
    ts = sorted(gt)
    return span, float(np.linalg.norm(gt[ts[-1]] - gt[ts[0]]))


def run(n_frames=50, out_dir: Optional[str] = ".", n_features=500,
        device="cuda", verbose=True, cfg: Optional[SlamConfig] = None,
        tex_scale: float = 220.0, pipelined=False, async_mapping=False):
    """Track the orbit's pairs through System.track_stereo (pipelined:
    track_stereo_pipelined; cfg: the camera, make_config(n_features=
    n_features) by default; out_dir None writes no files). Returns (system,
    SE3-aligned ATE RMSE in m, span, true span)."""
    cfg = make_config(n_features=n_features) if cfg is None else cfg
    pairs, poses = render_pairs(cfg, n_frames, tex_scale)
    slam = System(cfg, Sensor.STEREO, device=device,
                  async_mapping=async_mapping)
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}
    items = ((left, right, i / 30.0) for i, (left, right) in enumerate(pairs))
    track = (slam.track_stereo_pipelined(items) if pipelined
             else (slam.track_stereo(*it) for it in items))
    for i, _ in enumerate(track):
        if verbose:
            r = slam.telemetry.records[-1]
            print(f"frame {i:3d} state={slam.get_tracking_state().name:16s} "
                  f"tracked={r['n_tracked']:4d} kfs={r['n_kfs']} "
                  f"mps={r['n_mps']} track={r['track_ms']:.1f} ms "
                  f"mapping={r['mapping_ms']:.1f} ms", flush=True)
    slam.shutdown()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        slam.save_trajectory_kitti(os.path.join(out_dir, "CameraTrajectory.txt"))
        slam.save_keyframe_trajectory_tum(
            os.path.join(out_dir, "KeyFrameTrajectory.txt"))
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    rmse = traj_io.ate_rmse(est, gt, with_scale=False)   # metric: SE3 only
    span, span_gt = metric_span(est, gt)
    if verbose:
        print(f"frames tracked: {sum(1 for *_, lost in est if not lost)}"
              f"/{n_frames}")
        print(f"ATE RMSE (SE3-aligned): {rmse * 100:.2f} cm | metric span "
              f"est/gt = {span:.3f}/{span_gt:.3f}")
    return slam, rmse, span, span_gt


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=50)
    ap.add_argument("out_dir", nargs="?", default=".")
    ap.add_argument("--features", type=int, default=500)
    ap.add_argument("--settings", default=None,
                    help="a reference settings yaml, loaded for Sensor.STEREO")
    ap.add_argument("--tex-scale", type=float, default=220.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch paths, no kernels)")
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--async-mapping", action="store_true")
    a = ap.parse_args()
    cfg = load_settings(a.settings, Sensor.STEREO) if a.settings else None
    run(a.n_frames, a.out_dir, a.features, "cpu" if a.cpu else "cuda",
        cfg=cfg, tex_scale=a.tex_scale, pipelined=a.pipelined,
        async_mapping=a.async_mapping)


if __name__ == "__main__":
    main()
