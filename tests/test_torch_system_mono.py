"""The port's monocular System end to end on the CPU, against the bars of
tests/test_e2e_mono.py and against the JAX System on the same frames.

The port runs through drivers/mono_synthetic.run at that test's settings:
320x240, 400 features, 25 frames of the textured-plane orbit. The JAX System tracks the same rendered frames with vocabulary
self-training off (the port has no place recognition yet; without it the
JAX loop closer stays idle too). Criteria: the e2e file's five checks; both
systems initialize on the same frame and track the same number of frames;
their ATEs differ by < 1 cm.
"""

import numpy as np
import pytest

from orb_slam_system_tpu.config import (CameraConfig as JCameraConfig,
                                        ORBConfig as JORBConfig,
                                        SlamConfig as JSlamConfig)
from orb_slam_system_tpu.dataio import trajectory as jtraj
from orb_slam_system_tpu.models.system import System as JSystem
from orb_slam_system_tpu_torch.config import TrackingState
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.drivers.mono_synthetic import (make_config,
                                                              render_sequence,
                                                              run)

N_FRAMES, N_FEATURES = 25, 400


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_e2e")
    slam, rmse = run(n_frames=N_FRAMES, out_dir=str(out), n_features=N_FEATURES,
                     device="cpu", verbose=False)
    return slam, rmse, out


@pytest.fixture(scope="module")
def jax_run():
    pcfg = make_config(320, 240, N_FEATURES)
    frames, poses = render_sequence(pcfg, N_FRAMES)
    c = pcfg.camera
    cfg = JSlamConfig(camera=JCameraConfig(
        fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, fps=30.0, width=c.width,
        height=c.height), orb=JORBConfig(n_features=N_FEATURES))
    slam = JSystem(None, cfg)
    slam.place_rec.allow_self_train = False
    gt, states = {}, []
    for i, (img, T) in enumerate(zip(frames, poses)):
        slam.track_monocular(img, i / 30.0)
        gt[i / 30.0] = (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
        states.append(int(slam.get_tracking_state()))
    slam.shutdown()
    est = jtraj.frame_poses(slam.arena, slam.tracker.trajectory)
    return slam, jtraj.ate_rmse(est, gt), states, est


def test_tracks_and_maps(port_run):
    slam, _, _ = port_run
    assert slam.get_tracking_state() == TrackingState.OK
    assert slam.arena.n_keyframes() >= 3
    assert slam.arena.n_points() > 150


def test_ate_rmse(port_run):
    _, rmse, _ = port_run
    assert rmse < 0.03


def test_trajectory_files(port_run):
    _, _, out = port_run
    rows = [list(map(float, ln.split()))
            for ln in (out / "CameraTrajectory.txt").read_text().splitlines()]
    assert rows and all(len(r) == 8 for r in rows)
    ts = [r[0] for r in rows]
    assert ts == sorted(ts)
    for r in rows:
        assert abs(np.linalg.norm(r[4:8]) - 1.0) < 1e-3
    assert (out / "KeyFrameTrajectory.txt").read_text().strip()
    krows = [list(map(float, ln.split())) for ln in
             (out / "CameraTrajectoryKITTI.txt").read_text().splitlines()]
    assert all(len(r) == 12 for r in krows)
    M = np.asarray(krows[0]).reshape(3, 4)
    np.testing.assert_allclose(M[:3, :3] @ M[:3, :3].T, np.eye(3), atol=1e-5)


def test_covisibility_graph(port_run):
    slam, _, _ = port_run
    for kf_id, kf in slam.arena.kfs.items():
        if kf_id == slam.arena.kf_origin_id:
            continue
        assert kf.parent >= 0
        assert len(kf.covis) >= 1


def test_map_point_integrity(port_run):
    slam, _, _ = port_run
    for mp in slam.arena.mps.values():
        assert not mp.bad
        assert len(mp.obs) >= 1
        for kf_id, idx in mp.obs.items():
            kf = slam.arena.kfs.get(kf_id)
            if kf is not None:
                assert kf.mp_ids[idx] == mp.id
        assert mp.max_dist >= mp.min_dist >= 0


def test_matches_jax_system(port_run, jax_run):
    """Same initialization frame, same number of tracked frames, ATE
    within 1 cm of the JAX System's."""
    slam, rmse, _ = port_run
    jslam, jrmse, jstates, jest = jax_run
    states = [r["state"] for r in slam.telemetry.records]
    ok = int(TrackingState.OK)
    assert states.index(ok) == jstates.index(ok)
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    assert (sum(1 for *_, lost in est if not lost)
            == sum(1 for *_, lost in jest if not lost))
    assert jrmse < 0.03
    assert abs(rmse - jrmse) < 0.01, (rmse, jrmse)


def test_reset_reinitializes():
    """System.reset clears the map and the tracker (reference
    Tracking::Reset); the next frames initialize a new map, whose keyframe
    ids continue the old ones."""
    from orb_slam_system_tpu_torch.models.system import System
    cfg = make_config(320, 240, N_FEATURES)
    frames, _ = render_sequence(cfg, 6)
    slam = System(cfg, device="cpu")
    for i in range(2):
        slam.track_monocular(frames[i], i / 30.0)
    assert slam.get_tracking_state() == TrackingState.OK
    first_kfs = sorted(slam.arena.kfs)
    slam.reset()
    assert slam.get_tracking_state() == TrackingState.NOT_INITIALIZED
    assert not slam.arena.kfs and not slam.arena.mps
    assert not slam.local_mapper.queue and slam.tracker.velocity is None
    for i in range(2, 6):
        slam.track_monocular(frames[i], i / 30.0)
    assert slam.get_tracking_state() == TrackingState.OK
    assert min(slam.arena.kfs) > max(first_kfs)
    assert slam.arena.n_points() > 150
