"""Long end-to-end runs of the port against the JAX System on the CPU
(marked slow: each takes minutes, so Tier-1 leaves them out).

  * The 90-frame degraded circle at 320x240 (tests/test_e2e_loop.py's
    short run) through both packages, the JAX global BA made synchronous
    through its environment variable and the port's through sync_gba: the
    same loops closed, loop keyframe and matched keyframe, the same frames
    tracked, ATE within 0.2 cm of each other, and tests/test_e2e_loop.py's
    bars (>= 1 loop, >= 80 of 90 tracked, ATE < 10 cm).
  * chip_smoke.py phase 6's far view at 640x480: both Systems over the
    60-frame orbit, frame 30's view relocalized, then the view 5 m off the
    orbit forced LOST: it stays LOST in both, for the same reason.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

pytestmark = pytest.mark.slow


def _matched(lc):
    kf = lc.arena.kfs.get(lc.last_loop_kf_id)
    return sorted(kf.loop_edges) if kf is not None else []


def test_loop_circle_matches_jax(monkeypatch):
    monkeypatch.setenv("ORB_SLAM_TPU_SYNC_GBA", "1")
    from examples.loop_synthetic import run as jrun
    from orb_slam_system_tpu_torch.drivers.loop_synthetic import run
    jslam, jrmse, jn = jrun(n_frames=90, verbose=False)
    slam, rmse, n = run(90, device="cpu", sync_gba=True, verbose=False)
    jlc, lc = jslam.loop_closer, slam.loop_closer
    print(f"JAX: loops {jlc.n_loops_closed} at keyframe {jlc.last_loop_kf_id} "
          f"-> {_matched(jlc)}, {jn}/90 tracked, ATE {jrmse * 100:.3f} cm; "
          f"port: loops {lc.n_loops_closed} at keyframe {lc.last_loop_kf_id} "
          f"-> {_matched(lc)}, {n}/90 tracked, ATE {rmse * 100:.3f} cm")
    assert lc.n_loops_closed == jlc.n_loops_closed >= 1
    assert lc.last_loop_kf_id == jlc.last_loop_kf_id
    assert _matched(lc) == _matched(jlc)
    assert n == jn >= 80
    assert abs(rmse - jrmse) < 0.002 and rmse < 0.10
    assert slam.tracker.epoch_violations == 0


def test_far_view_reason_640x480_matches_jax():
    from orb_slam_system_tpu.config import (CameraConfig as JCameraConfig,
                                            ORBConfig as JORBConfig,
                                            SlamConfig as JSlamConfig)
    from orb_slam_system_tpu.models.system import System as JSystem
    from orb_slam_system_tpu_torch.config import TrackingState
    from orb_slam_system_tpu_torch.drivers import mono_synthetic
    from orb_slam_system_tpu_torch.models.system import System
    cfg = mono_synthetic.make_config(640, 480, 1000)
    frames, poses = mono_synthetic.render_sequence(cfg, 60)
    c = cfg.camera
    jslam = JSystem(None, JSlamConfig(camera=JCameraConfig(
        fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, fps=30.0, width=c.width,
        height=c.height), orb=JORBConfig(n_features=1000)))
    jslam.local_mapper.loop_closer = None
    port = System(cfg, device="cpu")
    renderer = mono_synthetic.make_renderer(cfg)
    T_far = poses[0].copy()
    T_far[:3, 3] += np.array([5.0, 5.0, 0.0])
    views = (renderer.render(poses[30]), renderer.render(T_far))
    out = []
    for slam in (jslam, port):
        for i, img in enumerate(frames):
            slam.track_monocular(img, i / 30.0)
        states = []
        for k, img in enumerate(views):
            slam.tracker.state = type(slam.tracker.state).LOST
            slam.tracker.velocity = None
            slam.track_monocular(img, 1000.0 + k)
            states.append(slam.get_tracking_state().name)
        out.append((slam.arena.n_keyframes(), slam.arena.n_points(), states,
                    dict(slam.tracker.reloc_stats)))
    print(f"JAX: {out[0]}; port: {out[1]}")
    assert out[0] == out[1]
    assert out[1][2] == [TrackingState.OK.name, TrackingState.LOST.name]
    assert out[1][3].get("no_candidates") == 1
