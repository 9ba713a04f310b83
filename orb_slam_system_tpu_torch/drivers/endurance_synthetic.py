"""Endurance driver for the port: a long monocular run with several loop
closures over a map of hundreds of keyframes (the JAX package's
examples/endurance_synthetic.py).

    python -m orb_slam_system_tpu_torch.drivers.endurance_synthetic \\
        [n_frames] [out.json] [leaves] [--pipelined] [--async-mapping] \\
        [--device cuda|cpu]

The trajectory is a clover of `leaves` circles tangent at the origin, each
~11.3 m around and flown once, so every return to the junction can close a
loop; 250 frames a circle (1250 frames, 5 leaves, the JAX gate's shape) is
~4.5 cm a frame. The middle of every circle (a quarter to 60% of it) is
degraded with blur and default_rng(1) noise, drawn in render order, so
drift builds up for the closures to correct. The run exercises what keeps
the map bounded at scale: windowed local BA, keyframe and point culling,
the capped local map, and the global BA past GBA_DENSE_MAX_CAMS keyframes
(its PCG solver). The summary holds the frames tracked, keyframes at the
end and at the peak, loops, ATE, host ms per frame by thirds (median and
p90), the local mapper's stage ms over its first and last 20 calls, the
loop, chain, relocalization and keyframe-wait funnels and the median
points per keyframe.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture)
from orb_slam_system_tpu_torch.drivers._driver_util import add_device_arg
from orb_slam_system_tpu_torch.drivers.loop_synthetic import blur
from orb_slam_system_tpu_torch.drivers.mono_synthetic import make_config
from orb_slam_system_tpu_torch.models.system import System

BLUR_TAPS = 4      # the JAX example's kernel, arange(-4, 5)


def clover_trajectory(n_frames: int, radius: float = 1.8,
                      depth: float = -2.0, tilt: float = 0.3,
                      leaves: int = 4):
    """Circles tangent at the origin, headings 360/leaves degrees apart,
    each flown once from the junction back to it. A list of Tcw (4x4)."""
    ct, st_ = np.cos(tilt), np.sin(tilt)
    R_tilt = np.array([[1.0, 0.0, 0.0], [0.0, ct, -st_], [0.0, st_, ct]])
    R = R_tilt.T
    per = n_frames // leaves
    poses = []
    for i in range(n_frames):
        leaf = min(i // per, leaves - 1)
        a = 2 * np.pi * (i - leaf * per) / per
        th = leaf * (2 * np.pi / leaves)
        cx, cy = radius * np.cos(th), radius * np.sin(th)
        px = cx - radius * np.cos(th + a)
        py = cy - radius * np.sin(th + a)
        C = np.array([px, py, depth])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ C
        poses.append(T)
    return poses


def degraded_frames(cfg, n_frames: int, leaves: int, noise: float = 3.5,
                    blur_sigma: float = 1.5):
    """Yields (i, Tcw, rendered image) of the clover through cfg's camera,
    in order, the middle of each circle blurred and noised with
    default_rng(1) as the frames are made (the JAX example's make_frame)."""
    renderer = make_renderer(cfg)
    rng = np.random.default_rng(1)
    per = n_frames // leaves
    for i, Tcw in enumerate(clover_trajectory(n_frames, leaves=leaves)):
        img = renderer.render(Tcw)
        if 0.25 <= (i % per) / per <= 0.6:
            img = (blur(img, blur_sigma, BLUR_TAPS).astype(np.float32)
                   + rng.normal(size=img.shape).astype(np.float32) * noise)
        yield i, Tcw, img


def make_renderer(cfg) -> PlanarSceneRenderer:
    """The clover's ground: ~18 m of unique texture covers its +-4.5 m (the
    renderer clamps outside it, which would leave no features)."""
    return PlanarSceneRenderer(cfg.camera.K, cfg.camera.width,
                               cfg.camera.height,
                               texture=make_texture(size=4096, block=8, seed=7),
                               tex_scale=220.0)


def run(n_frames=1000, out_json=None, verbose=True, n_features=400,
        noise=3.5, blur_sigma=1.5, async_mapping=False, leaves=4,
        pipelined=False, device="cuda", chain_classic_kf=False,
        kf_async_queue=3, kf_async_wait_s=10.0, kf_sync_flush_ratio=0.6,
        kf_drain_release_on_expansion=True):
    """Track the clover at 320x240 through System.track_monocular (or,
    pipelined, track_monocular_pipelined). The last five arguments set the
    tracker's keyframe-admission knobs (models/tracking_init.py; the JAX
    example reads them from ORB_SLAM_* environment variables).
    Returns (system, summary dict)."""
    cfg = make_config(n_features=n_features)
    slam = System(cfg, device=device, async_mapping=async_mapping)
    tr = slam.tracker
    tr.chain_classic_kf = chain_classic_kf
    tr.kf_async_queue = kf_async_queue
    tr.kf_async_wait_s = kf_async_wait_s
    tr.kf_sync_flush_ratio = kf_sync_flush_ratio
    tr.kf_drain_release_on_expansion = kf_drain_release_on_expansion
    gt = {}
    host_ms = []
    kf_counts = []
    loop_counts = []
    t_start = time.perf_counter()

    def frames():
        for i, Tcw, img in degraded_frames(cfg, n_frames, leaves, noise,
                                           blur_sigma):
            ts = i / 30.0
            gt[ts] = (-Tcw[:3, :3].T @ Tcw[:3, 3]).astype(np.float64)
            yield img, ts

    def note(i, t0):
        host_ms.append((time.perf_counter() - t0) * 1e3)
        kf_counts.append(slam.arena.n_keyframes())
        loop_counts.append(slam.loop_closer.n_loops_closed)
        if verbose and i % 25 == 0:
            print(f"frame {i:4d} {slam.get_tracking_state().name:16s} "
                  f"kfs={kf_counts[-1]:4d} mps={slam.arena.n_points():5d} "
                  f"loops={loop_counts[-1]} host={host_ms[-1]:.0f}ms",
                  flush=True)

    if pipelined:
        # Host time per frame here includes the render (the generator runs
        # inside the pipeline's pull loop).
        t0 = time.perf_counter()
        for i, _ in enumerate(slam.track_monocular_pipelined(frames())):
            note(i, t0)
            t0 = time.perf_counter()
    else:
        for i, (img, ts) in enumerate(frames()):
            t0 = time.perf_counter()
            slam.track_monocular(img, ts)
            note(i, t0)
    slam.shutdown()
    wall_s = time.perf_counter() - t_start
    est = traj_io.frame_poses(slam.arena, tr.trajectory)
    rmse = traj_io.ate_rmse(est, gt)
    n_tracked = sum(1 for _, _, lost in est if not lost)

    # Host time by thirds of the run (medians hold against keyframe spikes).
    third = n_frames // 3
    thirds = (host_ms[:third], host_ms[third:2 * third], host_ms[2 * third:])
    med = lambda xs: float(np.median(xs)) if len(xs) else 0.0  # noqa: E731
    history = slam.local_mapper.stage_ms.history
    summary = {
        "n_frames": n_frames,
        "n_tracked": n_tracked,
        "n_keyframes_final": slam.arena.n_keyframes(),
        "n_keyframes_peak": int(max(kf_counts)),
        "n_points_final": slam.arena.n_points(),
        "loops_closed": int(loop_counts[-1]),
        "ate_rmse_m": float(rmse),
        "wall_s": wall_s,
        "loop_stats": dict(slam.loop_closer.stats),
        "chain_stats": dict(tr.chain_stats),
        "reloc_stats": dict(tr.reloc_stats),
        "kf_wait_stats": dict(tr.kf_wait_stats),
        # Median map points per keyframe (thin keyframes starve the loop
        # detector's keyframe-to-keyframe matching).
        "kf_mp_median": float(np.median(
            [int((kf.mp_ids >= 0).sum()) for kf in slam.arena.kfs.values()]
        )) if slam.arena.kfs else 0.0,
        "host_ms_median_thirds": [med(x) for x in thirds],
        "host_ms_p90_thirds": [float(np.percentile(x, 90)) for x in thirds],
        "stage_ms_first20_mean": {k: float(np.mean(list(v)[:20]))
                                  for k, v in history.items()},
        "stage_ms_last20_mean": {k: float(np.mean(list(v)[-20:]))
                                 for k, v in history.items()},
    }
    print(json.dumps(summary, indent=2))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(summary, f, indent=2)
    return slam, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=1000)
    ap.add_argument("out_json", nargs="?", default=None)
    ap.add_argument("leaves", nargs="?", type=int, default=4)
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--async-mapping", action="store_true")
    add_device_arg(ap)
    a = ap.parse_args(argv)
    run(a.n_frames, a.out_json, leaves=a.leaves, pipelined=a.pipelined,
        async_mapping=a.async_mapping, device=a.device)


if __name__ == "__main__":
    main()
