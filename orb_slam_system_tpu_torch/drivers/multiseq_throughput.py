"""Batched multi-sequence SLAM throughput (BASELINE.json config 5, "batched
multi-sequence EuRoC MH01-05 mapping on one chip"): the JAX package's
examples/multiseq_throughput.py on the port.

The default mode runs S complete SLAM Systems (tracking, local mapping and
loop closing each) over S distinct synthetic sequences, with the steady
frames' extraction shared as one batched call (parallel/multi_system
.MultiSystem). It writes one TUM trajectory per sequence and reports the
aggregate frames per second and the ATE of each sequence.

--frontend times the batched front-end step instead (parallel/multiseq:
extraction, Hamming matching and a pose LM for S sequences at once).

    python -m orb_slam_system_tpu_torch.drivers.multiseq_throughput \\
        [n_sequences] [n_frames] [out_dir] [--frontend] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig, Sensor,
                                              SlamConfig, TrackingState)
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.drivers._driver_util import add_device_arg
from orb_slam_system_tpu_torch.parallel.multi_system import MultiSystem
from orb_slam_system_tpu_torch.parallel.multiseq import make_multiseq_step


# The JAX example's --frontend shape.
FRONTEND_H, FRONTEND_W, FRONTEND_FEATURES, FRONTEND_LEVELS = 240, 320, 512, 4


def default_camera(width: int = 320, height: int = 240) -> CameraConfig:
    """The JAX example's pinhole camera: fx = fy = 260 at 320x240."""
    return CameraConfig(fx=260.0, fy=260.0, cx=width / 2, cy=height / 2,
                        fps=30.0, width=width, height=height)


def sequence_scenes(n_seq: int, n_frames: int, camera: CameraConfig):
    """(renderers, trajectories) of the S sequences: texture seed 7 + s and
    orbit radius 0.30 + 0.02 s (the JAX example's scenes), the texture
    scale 220 * fx / 260 (the JAX example's 220 at its camera)."""
    tex_scale = 220.0 * camera.fx / 260.0
    renderers = [
        PlanarSceneRenderer(camera.K, camera.width, camera.height,
                            texture=make_texture(2048, 8, seed=7 + s),
                            tex_scale=tex_scale)
        for s in range(n_seq)]
    trajs = [orbit_trajectory(n_frames, radius=0.30 + 0.02 * s, depth=-2.0,
                              tilt=0.3) for s in range(n_seq)]
    return renderers, trajs


def run_full(n_seq: int = 4, n_frames: int = 40, out_dir: str | None = ".",
             n_features: int = 400, verbose: bool = True, device="cuda",
             camera: CameraConfig | None = None):
    """S full Systems over S synthetic sequences through
    MultiSystem.track_batch; out_dir None writes no trajectory files.
    camera: the frame size and intrinsics (default_camera() when None).
    Returns (multi_system, ATE RMSE per sequence in m, aggregate fps)."""
    cam = default_camera() if camera is None else camera
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=n_features),
                     sensor=Sensor.MONOCULAR)
    renderers, trajs = sequence_scenes(n_seq, n_frames, cam)
    ms = MultiSystem(cfg, n_seq, device=device)
    gts = [dict() for _ in range(n_seq)]
    for i in range(n_frames):
        ts = i / cam.fps
        imgs = np.stack([renderers[s].render(trajs[s][i])
                         for s in range(n_seq)])
        ms.track_batch(imgs, ts)
        for s in range(n_seq):
            T = trajs[s][i]
            gts[s][ts] = (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
        if verbose and i % 10 == 0:
            states = "".join(
                sy.get_tracking_state().name[0] for sy in ms.systems)
            print(f"frame {i:3d} states={states} "
                  f"kfs={[sy.arena.n_keyframes() for sy in ms.systems]}",
                  flush=True)
    ms.shutdown()
    fps = ms.aggregate_fps()
    ates = []
    for s, sy in enumerate(ms.systems):
        est = traj_io.frame_poses(sy.arena, sy.tracker.trajectory)
        ates.append(traj_io.ate_rmse(est, gts[s]))
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            sy.save_trajectory_tum(
                os.path.join(out_dir, f"CameraTrajectory_seq{s}.txt"))
    if verbose:
        n_ok = sum(1 for sy in ms.systems
                   if sy.get_tracking_state() == TrackingState.OK)
        print(f"sequences={n_seq} frames/seq={n_frames} "
              f"aggregate fps={fps:.1f} ok_final={n_ok}/{n_seq} "
              f"({ms.device})")
        print("ATE per sequence (cm): "
              + " ".join(f"{a * 100:.2f}" for a in ates))
    return ms, ates, fps


def run_frontend(n_seq: int = 8, n_frames: int = 20, device="cuda") -> dict:
    """Time the batched front-end step over S rendered sequences (the JAX
    example's: texture seed s, one orbit of radius 0.3) against the
    example arguments' previous-frame state. Returns {"fps", "ms_per_frame",
    "frames", "step", "inputs" and "outputs" of the last step}."""
    height, width = FRONTEND_H, FRONTEND_W
    step, example = make_multiseq_step(height, width, FRONTEND_FEATURES,
                                       FRONTEND_LEVELS, n_seq, device)
    K = np.array([[260.0, 0, width / 2], [0, 260.0, height / 2], [0, 0, 1]],
                 np.float32)
    renderers = [PlanarSceneRenderer(K, width, height,
                                     texture=make_texture(1024, 8, seed=s),
                                     tex_scale=220.0)
                 for s in range(n_seq)]
    trajs = [orbit_trajectory(n_frames, radius=0.3, depth=-2.0, tilt=0.3)
             for _ in range(n_seq)]
    _, prev_desc, prev_valid, pts, Tcw0 = example
    int(step(*example)[1])                      # warm-up, then wait for it
    t_total, frames = 0.0, 0
    for f in range(n_frames):
        imgs = np.stack([renderers[s].render(trajs[s][f])
                         for s in range(n_seq)])
        t0 = time.perf_counter()
        out = step(imgs, prev_desc, prev_valid, pts, Tcw0)
        int(out[1])                             # waits for the step
        t_total += time.perf_counter() - t0
        frames += n_seq
    res = dict(fps=frames / t_total, ms_per_frame=t_total / frames * 1e3,
               frames=frames, step=step,
               inputs=(imgs, prev_desc, prev_valid, pts, Tcw0), outputs=out)
    print(f"sequences={n_seq} frames={frames} aggregate frontend "
          f"fps={res['fps']:.1f} ({res['ms_per_frame']:.1f} ms/frame, "
          f"{torch.device(device)})")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_sequences", nargs="?", type=int, default=4)
    ap.add_argument("n_frames", nargs="?", type=int, default=40)
    ap.add_argument("out_dir", nargs="?", default=".")
    ap.add_argument("--frontend", action="store_true")
    add_device_arg(ap)
    a = ap.parse_args(argv)
    if a.frontend:
        return run_frontend(a.n_sequences, a.n_frames, a.device)
    return run_full(a.n_sequences, a.n_frames, a.out_dir, device=a.device)


if __name__ == "__main__":
    main()
