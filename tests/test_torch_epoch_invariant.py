"""The correction-exclusion invariant in the port (the counterpart of
tests/test_epoch_invariant.py), on the CPU at that test's camera (640x480,
fx 520, 400 features).

1. The tripwire: Tracker._store_trajectory refuses a frame whose span saw
   arena.pose_epoch move without a re-anchor (counted in
   epoch_violations, raised, nothing stored), and stores normally once the
   frame's epoch is refreshed.
2. A rigid map correction (points moved by G, poses by G^-1 on the right,
   pose_epoch bumped: a loop or global-BA apply's shape) injected into
   every correction_unlocked() window the tracker opens in a pipelined run
   with the async mapper, where a queue of one keyframe and a flush ratio
   of 100 open a window at every keyframe: the run ends with no
   violation, >= 85% of the frames OK and an ATE under 5 cm.

The orbit is the JAX test's, cut from its 14 and 40 frames to 10 and 30
to keep the file near a minute on one CPU thread (every bar kept).
"""

import contextlib

import numpy as np
import pytest
import torch

from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig, Sensor,
                                              SlamConfig, TrackingState)
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.models.system import System


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRIPWIRE_FRAMES = 10
STRESS_FRAMES = 30


def _make_system(async_mapping):
    W, H = 640, 480
    cam = CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=400),
                     sensor=Sensor.MONOCULAR)
    r = PlanarSceneRenderer(cam.K, W, H, texture=make_texture(2048, 8, 7),
                            tex_scale=220.0)
    return System(cfg, device="cpu", async_mapping=async_mapping), r


def test_store_trajectory_tripwire():
    slam, r = _make_system(async_mapping=False)
    poses = orbit_trajectory(TRIPWIRE_FRAMES, radius=0.35, depth=-2.0,
                             tilt=0.3)
    for i, Tcw in enumerate(poses):
        slam.track_monocular(r.render(Tcw), i / 30.0)
    tr = slam.tracker
    assert tr.state == TrackingState.OK
    assert tr.epoch_violations == 0
    # An epoch moved inside the frame's span, and nothing re-anchored.
    tr._frame_epoch = tr.arena.pose_epoch
    tr.arena.pose_epoch += 1
    n_before = len(tr.trajectory)
    with pytest.raises(RuntimeError, match="pose_epoch moved"):
        tr._store_trajectory()
    assert tr.epoch_violations == 1
    assert len(tr.trajectory) == n_before
    # Re-anchored: stored again.
    tr._frame_epoch = tr.arena.pose_epoch
    tr._store_trajectory()
    assert len(tr.trajectory) == n_before + 1
    tr.arena.pose_epoch -= 1
    tr._frame_epoch = tr.arena.pose_epoch
    slam.shutdown()


def _rigid_world_move(arena, seed):
    """A map-wide rigid correction: points by G, keyframe poses by G^-1 on
    the right, pose_epoch bumped. Projections do not change, so a tracker
    that re-anchors is unaffected; one that misses it is off by G."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=3) * 0.02
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = (np.eye(3) + (np.sin(th) / max(th, 1e-12)) * K
         + ((1 - np.cos(th)) / max(th, 1e-12) ** 2) * (K @ K))
    G = np.eye(4, dtype=np.float64)
    G[:3, :3] = R
    G[:3, 3] = rng.normal(size=3) * 0.05
    Ginv = np.linalg.inv(G)
    arena.pose_epoch += 1
    for kf in arena.kfs.values():
        kf.Tcw = (kf.Tcw.astype(np.float64) @ Ginv).astype(np.float32)
    for mp in arena.mps.values():
        if not mp.bad:
            arena.set_point_pos(
                mp, (G[:3, :3] @ mp.pos + G[:3, 3]).astype(np.float32))
    arena.version += 1
    arena.pose_epoch += 1


def test_corrections_injected_into_every_wait_window():
    slam, r = _make_system(async_mapping=True)
    tr = slam.tracker
    tr.kf_async_queue = 1          # the queue is full at once: waits open
    tr.kf_async_wait_s = 30.0
    # Every keyframe takes the fragile-flush path (inliers always below 100x
    # their average), so its correction_unlocked() window opens at every
    # insertion, whatever the worker's pace.
    tr.kf_sync_flush_ratio = 100.0
    arena = slam.arena
    injections = [0]
    orig_cu = arena.correction_unlocked

    def injecting_cu():
        cm = orig_cu()

        @contextlib.contextmanager
        def _cm():
            with cm:
                # The window is open: inject the correction a worker-side
                # loop closure could land here.
                with arena.correction_lock, arena.lock:
                    if arena.kfs:
                        _rigid_world_move(arena, injections[0])
                        injections[0] += 1
                yield
        return _cm()

    arena.correction_unlocked = injecting_cu
    poses = orbit_trajectory(STRESS_FRAMES, radius=0.35, depth=-2.0, tilt=0.3)
    frames = [(r.render(T), i / 30.0) for i, T in enumerate(poses)]
    gt = {ts: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for (_, ts), T in zip(frames, poses)}
    n_ok = 0
    try:
        for _ in slam.track_monocular_pipelined(iter(frames), depth=2):
            n_ok += tr.state == TrackingState.OK
    finally:
        arena.correction_unlocked = orig_cu
        slam.shutdown()
    assert injections[0] >= 3, f"no wait window was exercised ({injections[0]})"
    assert tr.epoch_violations == 0
    assert n_ok >= 0.85 * STRESS_FRAMES, (n_ok, STRESS_FRAMES)
    rmse = traj_io.ate_rmse(traj_io.frame_poses(arena, tr.trajectory), gt)
    assert rmse < 0.05, rmse
