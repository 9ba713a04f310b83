"""Loop-closure driver for the port: the System over a closed circle whose
middle segment is degraded (blur + noise), so real scale and pose drift
accumulate until the revisit closes the loop: BoW detection -> Sim3 ->
correction -> essential graph -> global BA (the JAX package's
examples/loop_synthetic.py).

    python -m orb_slam_system_tpu_torch.drivers.loop_synthetic \\
        [n_frames] [out_dir] [--cpu] [--width W --height H --features N] \\
        [--pipelined] [--async-mapping]

The camera, the texture scale and the blur scale with the width
(drivers/mono_synthetic.make_config; blur sigma 1.8 * width / 320 over
+-4 * width / 320 taps), so 320x240 is the JAX example's scene exactly.
Frames int(0.18 n) to int(0.53 n) are degraded, with default_rng(1) noise
of sigma 4.5. Prints the loops closed, the frames tracked and the
Sim3-aligned ATE RMSE, and writes the trajectories. --pipelined tracks the
circle through System.track_monocular_pipelined, so the loop correction
lands with chain steps in flight on the old map (their results are
dropped and the frames tracked classically); --async-mapping runs the
mapper and the loop closer on the worker thread.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.synthetic import loop_trajectory
from orb_slam_system_tpu_torch.drivers.mono_synthetic import (make_config,
                                                              make_renderer,
                                                              track_frames)
from orb_slam_system_tpu_torch.models.system import System

NOISE = 4.5


def blur(img: np.ndarray, sigma: float, taps: int) -> np.ndarray:
    """Separable Gaussian blur with 2 * taps + 1 taps, zero-padded at the
    border (np.convolve mode "same", as the JAX example)."""
    k = np.exp(-np.arange(-taps, taps + 1) ** 2 / (2 * sigma ** 2))
    k /= k.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
    return np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, img)


def render_sequence(cfg, n_frames: int):
    """(frames f32[H,W] list, true Tcw list) of the degraded circle."""
    renderer = make_renderer(cfg)
    poses = loop_trajectory(n_frames, radius=1.6, depth=-2.0, tilt=0.3)
    scale = cfg.camera.width / 320
    rng = np.random.default_rng(1)
    lo, hi = int(0.18 * n_frames), int(0.53 * n_frames)
    frames = []
    for i, T in enumerate(poses):
        img = renderer.render(T)
        if lo <= i <= hi:
            img = (blur(img, 1.8 * scale, round(4 * scale)).astype(np.float32)
                   + rng.normal(size=img.shape).astype(np.float32) * NOISE)
        frames.append(img)
    return frames, poses


def run(n_frames=170, out_dir=None, n_features=400, width=320, height=240,
        device="cuda", sync_gba=False, verbose=True, pipelined=False,
        async_mapping=False):
    """Track the circle through System.track_monocular (or, pipelined,
    track_monocular_pipelined). Returns (system, ATE RMSE in m, frames
    tracked)."""
    cfg = make_config(width, height, n_features)
    frames, poses = render_sequence(cfg, n_frames)
    slam = System(cfg, device=device, sync_gba=sync_gba,
                  async_mapping=async_mapping)
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}
    items = ((img, i / 30.0) for i, img in enumerate(frames))
    for i, _ in enumerate(track_frames(slam, items, pipelined)):
        if verbose:
            r = slam.telemetry.records[-1]
            print(f"frame {i:3d} state={slam.get_tracking_state().name:16s} "
                  f"kfs={r['n_kfs']} mps={r['n_mps']} loops={r['loops']} "
                  f"gba_applied={r['gba_applied']} track={r['track_ms']:.1f} "
                  f"ms mapping={r['mapping_ms']:.1f} ms", flush=True)
    slam.shutdown()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        slam.save_keyframe_trajectory_tum(
            os.path.join(out_dir, "KeyFrameTrajectory.txt"))
        slam.save_trajectory_tum(os.path.join(out_dir, "CameraTrajectory.txt"))
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    rmse = traj_io.ate_rmse(est, gt)
    n_tracked = sum(1 for _, _, lost in est if not lost)
    if verbose:
        lc = slam.loop_closer
        print(f"loops closed: {lc.n_loops_closed} (last: keyframe, matched "
              f"keyframe, Sim3 scale {lc.last_loop}); global BAs applied: "
              f"{lc.n_gba_applied}")
        print(f"frames tracked: {n_tracked}/{n_frames}")
        print(f"ATE RMSE (Sim3-aligned): {rmse * 100:.2f} cm")
    return slam, rmse, n_tracked


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=170)
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--features", type=int, default=400)
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
