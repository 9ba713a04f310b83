"""The port's RGB-D System end to end on the CPU, against the bars of
tests/test_e2e_rgbd.py and against the JAX System on the same frames, and
localization mode's temporary VO points.

Both Systems run once, in module fixtures, at that test's settings: 320x240,
fx 260, bf 260 x 0.08, th_depth 40 m, DepthMapFactor 5000, 500 features, 20
frames of the textured-plane orbit with analytic depth x 5000; the port
through drivers/rgbd_synthetic.run. Criteria: the e2e file's checks on the
port (ATE as that file computes it, Sim3-aligned); the same initialization
frame, keyframe count and frames tracked as the JAX System, and an ATE
within max(0.5 cm, 25%) of its ATE.
"""

import numpy as np
import pytest
import torch

from orb_slam_system_tpu_torch.config import Sensor, TrackingState
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.drivers.rgbd_synthetic import make_config, run


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_FRAMES = 20


def _gt(n):
    from orb_slam_system_tpu_torch.dataio.synthetic import orbit_trajectory
    return {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
            for i, T in enumerate(orbit_trajectory(n, radius=0.35, depth=-2.0,
                                                   tilt=0.3))}


@pytest.fixture(scope="module")
def port_run():
    slam, *_ = run(n_frames=N_FRAMES, out_dir=None, device="cpu", verbose=False)
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    return slam, est, traj_io.ate_rmse(est, _gt(N_FRAMES))


@pytest.fixture(scope="module")
def jax_run():
    from orb_slam_system_tpu.config import (CameraConfig, ORBConfig,
                                            Sensor as JSensor, SlamConfig)
    from orb_slam_system_tpu.dataio import trajectory as jtraj
    from orb_slam_system_tpu.dataio.synthetic import (PlanarSceneRenderer,
                                                      make_texture,
                                                      orbit_trajectory)
    from orb_slam_system_tpu.models.system import System as JSystem

    c = make_config().camera
    cam = CameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, fps=30.0,
                       width=c.width, height=c.height, bf=c.bf)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=500),
                     sensor=JSensor.RGBD, th_depth=40.0, depth_map_factor=5000.0)
    r = PlanarSceneRenderer(cam.K, c.width, c.height,
                            texture=make_texture(2048, 8, 7), tex_scale=220.0)
    slam = JSystem(None, cfg, JSensor.RGBD)
    for i, Tcw in enumerate(orbit_trajectory(N_FRAMES, radius=0.35, depth=-2.0,
                                             tilt=0.3)):
        slam.track_rgbd(r.render(Tcw), r.render_depth(Tcw) * 5000.0, i / 30.0)
    slam.shutdown()
    est = jtraj.frame_poses(slam.arena, slam.tracker.trajectory)
    return dict(rmse=jtraj.ate_rmse(est, _gt(N_FRAMES)),
                init_frame=slam.arena.kfs[slam.arena.kf_origin_id].frame_id,
                kfs=slam.arena.n_keyframes(),
                tracked=sum(1 for *_, lost in est if not lost))


def test_rgbd_tracks_metric(port_run):
    slam, est, rmse = port_run
    assert slam.get_tracking_state() == TrackingState.OK
    assert sum(1 for *_, lost in est if not lost) >= N_FRAMES - 2
    assert rmse < 0.05
    gt = _gt(N_FRAMES)
    pos = [(-T[:3, :3].T @ T[:3, 3]) for _, T, lost in est if not lost]
    span = np.linalg.norm(pos[-1] - pos[0])
    ts = sorted(gt)
    span_gt = np.linalg.norm(gt[ts[-1]] - gt[ts[0]])
    assert abs(span - span_gt) / max(span_gt, 1e-9) < 0.1


def test_rgbd_depth_seeding(port_run):
    slam, _, _ = port_run
    assert slam.arena.n_points() > 200
    kf0 = slam.arena.kfs[slam.arena.kf_origin_id]
    assert kf0.feats.depth is not None
    d = kf0.feats.depth[kf0.feats.valid]
    assert (d[d > 0] > 1.0).all() and (d[d > 0] < 10.0).all()   # metres


def test_matches_jax_system(port_run, jax_run):
    slam, est, rmse = port_run
    assert slam.arena.kfs[slam.arena.kf_origin_id].frame_id == jax_run["init_frame"]
    assert slam.arena.n_keyframes() == jax_run["kfs"]
    assert sum(1 for *_, lost in est if not lost) == jax_run["tracked"]
    assert abs(rmse - jax_run["rmse"]) <= max(0.005, 0.25 * jax_run["rmse"])


def test_track_calls_check_the_sensor(port_run):
    slam, _, _ = port_run
    assert slam.sensor == Sensor.RGBD
    img = np.zeros((240, 320), np.float32)
    with pytest.raises(RuntimeError):
        slam.track_monocular(img, 1.0)
    with pytest.raises(RuntimeError):
        slam.track_stereo(img, img, 1.0)


def test_localization_mode_vo_survives_map_loss():
    """tests/test_e2e_rgbd.py's case on the port: 8 frames mapped, then
    localization mode with every map association wiped from the last frame;
    tracking goes on over 8 more frames on temporary depth-backprojected
    VO points."""
    slam, _, _, _, ok_states, vo_used = run(n_frames=8, out_dir=None,
                                            device="cpu", verbose=False,
                                            localize=8)
    mapped = slam.telemetry.records[7]
    assert mapped["state"] == int(TrackingState.OK)
    assert slam.tracker.only_tracking
    assert ok_states[0], "VO points must carry the first map-less frame"
    assert vo_used, "temporary VO points were never created"
    assert ok_states[-1], "tracking did not survive the map-less stretch"
    assert slam.arena.n_keyframes() == mapped["n_kfs"], \
        "localization mode made a keyframe"
