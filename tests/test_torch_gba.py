"""Global BA after a loop closure, and tracking through a map-wide pose
rewrite, in the port on the CPU (the counterparts of tests/test_gba_async.py
and tests/test_map_correction_reanchor.py::
test_sequential_survives_global_pose_rewrite).

GBARunner + LoopCloser.poll_gba on a constructed map: keyframes born during
the solve follow their parent through the spanning tree and their points
re-anchor through the reference keyframe (1e-5 / 1e-4); an aborted solve
leaves nothing to apply; a solve on the side thread lands through poll_gba.
Then the System over 30 frames of the 320x240 orbit with the whole map moved
by a rigid transform before frame 20: every later frame stays OK, and the
pose epoch counts the one rewrite; a rewrite made INSIDE one more frame is
refused at the frame's end (counted, then raised).
"""

import numpy as np
import pytest
import torch

from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig, Sensor,
                                              SlamConfig, TrackingState)
from orb_slam_system_tpu_torch.drivers.mono_synthetic import (make_config,
                                                              render_sequence)
from orb_slam_system_tpu_torch.mapping.arena import FrameFeatures, MapArena
from orb_slam_system_tpu_torch.models.local_mapping import LocalMapper
from orb_slam_system_tpu_torch.models.loop_closing import LoopCloser
from orb_slam_system_tpu_torch.models.place_recognition import PlaceRecognition
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


FX = FY = 300.0
CX, CY = 160.0, 120.0
N_SLOTS = 128


def make_cfg():
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, width=320, height=240)
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=N_SLOTS),
                      sensor=Sensor.MONOCULAR)


def make_feats(uv, n_slots=N_SLOTS):
    n = len(uv)
    xy = np.zeros((n_slots, 2), np.float32)
    xy[:n] = uv
    return FrameFeatures(
        xy=xy, xy_und=xy.copy(), response=np.ones(n_slots, np.float32),
        angle=np.zeros(n_slots, np.float32),
        octave=np.zeros(n_slots, np.int32),
        desc=np.zeros((n_slots, 8), np.uint32), valid=np.arange(n_slots) < n)


def build_map(rng, n_kfs=5, noise=0.02):
    """tests/test_gba_async.py's map: a chain of keyframes along x observing
    one cloud, with noisy poses and points."""
    arena = MapArena()
    world = rng.uniform(-2, 2, size=(80, 3)).astype(np.float32)
    world[:, 2] = rng.uniform(4, 7, size=80)
    kfs = []
    for i in range(n_kfs):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -0.3 * i
        if i > 0:
            T[:3, 3] += rng.normal(scale=noise, size=3).astype(np.float32)
        Xc = world @ T[:3, :3].T + T[:3, 3]
        kf = arena.new_keyframe(i, float(i), T, make_feats(
            Xc[:, :2] / Xc[:, 2:3] * [FX, FY] + [CX, CY]))
        if i > 0:
            kf.parent = kfs[-1].id
            kfs[-1].children.add(kf.id)
        kfs.append(kf)
    arena.kf_origin_id = kfs[0].id
    for p in range(world.shape[0]):
        mp = arena.new_point(
            world[p] + rng.normal(scale=noise, size=3).astype(np.float32),
            np.zeros(8, np.uint32), kfs[0].id, kfs[0].id)
        for kf in kfs:
            arena.add_observation(mp, kf, p)
    return arena, kfs, world


def make_closer(arena):
    cfg = make_cfg()
    return LoopCloser(cfg, arena, PlaceRecognition(None, device="cpu"),
                      LocalMapper(cfg, arena, "cpu"), device="cpu")


def test_gba_propagates_to_keyframes_created_during_solve(rng):
    arena, kfs, world = build_map(rng)
    closer = make_closer(arena)
    snap = closer._build_gba_problem()
    assert snap is not None
    # Solved, not yet applied: a keyframe and a point arrive in between.
    closer.gba.start(snap, closer.cfg.camera, sync=True)
    T_new = np.eye(4, dtype=np.float32)
    T_new[0, 3] = -0.3 * len(kfs)
    late = arena.new_keyframe(99, 99.0, T_new, make_feats(np.zeros((1, 2))))
    late.parent = kfs[-1].id
    kfs[-1].children.add(late.id)
    late_pt = arena.new_point(world[0] + 0.5, np.zeros(8, np.uint32),
                              kfs[-1].id, kfs[-1].id)
    pre_parent = kfs[-1].Tcw.copy()
    Tcp_old = late.Tcw @ np.linalg.inv(pre_parent)
    pc_old = pre_parent[:3, :3] @ late_pt.pos + pre_parent[:3, 3]
    epoch = arena.pose_epoch

    assert closer.poll_gba()
    assert arena.pose_epoch == epoch + 1 and closer.n_gba_applied == 1
    np.testing.assert_allclose(late.Tcw, Tcp_old @ kfs[-1].Tcw, atol=1e-5)
    T_ref_new = kfs[-1].Tcw
    np.testing.assert_allclose(T_ref_new[:3, :3] @ late_pt.pos + T_ref_new[:3, 3],
                               pc_old, atol=1e-4)
    assert not np.allclose(pre_parent, kfs[-1].Tcw, atol=1e-7)


def test_gba_abort_discards_result(rng):
    arena, kfs, world = build_map(rng)
    closer = make_closer(arena)
    closer.gba.start(closer._build_gba_problem(), closer.cfg.camera, sync=False)
    closer.gba.abort()
    assert not closer.gba.running()
    assert closer.gba.take_result() is None
    assert not closer.poll_gba()


def test_gba_abort_after_finish_discards_result(rng):
    """The solve ends before abort(): the result is dropped all the same
    (the JAX runner keeps it, which races its own abort test under load)."""
    arena, kfs, world = build_map(rng)
    closer = make_closer(arena)
    closer.gba.start(closer._build_gba_problem(), closer.cfg.camera, sync=False)
    closer.gba.join()
    closer.gba.abort()
    assert closer.gba.take_result() is None
    assert not closer.poll_gba()


def test_gba_async_roundtrip(rng):
    arena, kfs, world = build_map(rng)
    closer = make_closer(arena)
    poses_before = {k.id: k.Tcw.copy() for k in kfs}
    closer.gba.start(closer._build_gba_problem(), closer.cfg.camera, sync=False)
    closer.gba.join()
    assert not closer.gba.running()
    assert closer.poll_gba()
    assert sum(not np.allclose(poses_before[k.id], k.Tcw, atol=1e-7)
               for k in kfs[1:]) >= 1
    assert closer.stage_ms.history["gba_solve"]


def _rigid_map_rewrite(arena, yaw=0.35, shift=(0.8, -0.5, 0.4)):
    """Move the whole map by one rigid world transform (what a GBA apply or
    a loop correction does to the arena, minus the optimization)."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    Rg = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]], np.float32)
    tg = np.asarray(shift, np.float32)
    Tg_inv = np.eye(4, dtype=np.float32)
    Tg_inv[:3, :3] = Rg.T
    Tg_inv[:3, 3] = -Rg.T @ tg
    for kf in arena.kfs.values():
        kf.Tcw = (kf.Tcw @ Tg_inv).astype(np.float32)
    for mp in arena.mps.values():
        arena.set_point_pos(mp, Rg @ mp.pos + tg)
        mp.normal = (Rg @ mp.normal).astype(np.float32)
    arena.pose_epoch += 1


def test_sequential_survives_global_pose_rewrite():
    n, rewrite_at = 30, 20
    frames, _ = render_sequence(make_config(320, 240, 400), n)
    slam = System(make_config(320, 240, 400), device="cpu", sync_gba=True)
    ok_after = 0
    for i, img in enumerate(frames):
        if i == rewrite_at:
            assert slam.get_tracking_state() == TrackingState.OK
            _rigid_map_rewrite(slam.arena)
        slam.track_monocular(img, i / 30.0)
        if i >= rewrite_at and slam.get_tracking_state() == TrackingState.OK:
            ok_after += 1
    slam.shutdown()
    assert ok_after == n - rewrite_at, ok_after
    assert slam.arena.pose_epoch == 1
    assert slam.tracker.epoch_violations == 0
    tr = slam.tracker
    fused = tr.track_fused

    def rewrite_inside():
        _rigid_map_rewrite(slam.arena)
        return fused()
    tr.track_fused = rewrite_inside
    with pytest.raises(RuntimeError, match="pose_epoch moved from 1 to 2"):
        slam.track_monocular(frames[-1], n / 30.0)
    assert tr.epoch_violations == 1
