"""The port's async local mapper and the pipelined mode through a map-wide
pose rewrite, on the CPU (the counterparts of tests/test_async_mapping.py
and tests/test_map_correction_reanchor.py::
test_pipelined_survives_global_pose_rewrite, at 320x240 with 400 features).

  * System(async_mapping=True) tracks 16 frames of the orbit, maps (OK, >= 3
    keyframes, > 150 points, ATE < 3 cm) and shuts down clean (queue empty,
    worker stopped, no worker error); that System is the subject of the
    mapper tests below.
  * The worker's two-phase batch: one local BA and keyframe cull per
    expansion batch, also when the queue refilled during the refinement;
    _expanding cleared after an exception; a tracker reset fired under
    arena.lock while the worker waits for it does not deadlock.
  * Bounded-queue keyframe admission: at most kf_async_queue admitted while
    the mapper is busy; the backpressure drain releases arena.lock, ends at
    the expansion for a healthy frame and at the worker's idle for a
    fragile one (or with the full-drain knob), and drops the demand after
    kf_async_wait_s.
  * track_monocular_pipelined over 32 frames with the whole map moved by a
    rigid transform between two enqueues (before frame 20): the in-flight results are
    dropped by the pose-epoch check, every later frame but one stays OK.
  * The pipelined knobs: depth 3, chain_classic_kf, resync_every.
Every test that starts a thread runs under a timeout of its own.
"""

import threading
import time

import numpy as np
import pytest
import torch

from orb_slam_system_tpu_torch.config import TrackingState
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.drivers.mono_synthetic import (make_config,
                                                              render_sequence)
from orb_slam_system_tpu_torch.models.system import System

N_FEATURES = 400


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these runs: the suite runs several workers on
    a shared machine, where the default pool (a thread per core in every
    worker) spins against the other workers. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def within(seconds, fn, *args):
    """fn(*args) on a helper thread, failing if it takes longer than
    `seconds` (a deadlock then fails the test instead of hanging it)."""
    out = {}

    def body():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"{fn.__name__} took more than {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _system(n_frames, async_mapping):
    cfg = make_config(320, 240, N_FEATURES)
    frames, poses = render_sequence(cfg, n_frames)
    slam = System(cfg, device="cpu", async_mapping=async_mapping)
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 30.0)
    slam.shutdown()
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    return slam, traj_io.ate_rmse(est, gt)


@pytest.fixture(scope="module")
def async16():
    """An async System after 16 frames and its shutdown, with its ATE."""
    return within(240, _system, 16, True)


def test_async_mapping_tracks_and_maps(async16):
    slam, rmse = async16
    assert slam.get_tracking_state() == TrackingState.OK
    assert slam.arena.n_keyframes() >= 3
    assert slam.arena.n_points() > 150
    assert rmse < 0.03
    assert not slam.local_mapper.queue
    assert slam.local_mapper._thread is None
    assert slam.local_mapper.worker_errors == 0


def test_worker_batch_guarantees_ba_per_batch(async16, monkeypatch):
    mapper = async16[0].local_mapper
    kf_ids = list(async16[0].arena.kfs)
    calls = {"ba": 0, "cull": 0, "tri": 0}

    def fake_ba(kf):
        calls["ba"] += 1
        if calls["ba"] == 1:
            # The tracker refills the queue during the refinement: the next
            # batch still gets its own BA.
            mapper.queue.append(kf_ids[1])

    monkeypatch.setattr(mapper, "tri_and_fuse", lambda kf, do_fuse=True:
                        calls.__setitem__("tri", calls["tri"] + 1))
    monkeypatch.setattr(mapper, "local_ba", fake_ba)
    monkeypatch.setattr(mapper, "cull_keyframes", lambda kf:
                        calls.__setitem__("cull", calls["cull"] + 1))
    monkeypatch.setattr(mapper, "loop_closer", None)
    mapper.queue.clear()
    mapper.queue.append(kf_ids[0])
    mapper.process_pending()
    assert not mapper.queue
    assert calls == {"ba": 2, "cull": 2, "tri": 2}
    assert mapper._expanding is False


def test_expanding_cleared_on_exception(async16, monkeypatch):
    mapper = async16[0].local_mapper

    def boom(kf):
        raise RuntimeError("injected")

    monkeypatch.setattr(mapper, "process_new_keyframe", boom)
    mapper.queue.append(next(iter(async16[0].arena.kfs)))
    with pytest.raises(RuntimeError, match="injected"):
        mapper.process_pending()
    assert mapper._expanding is False
    mapper.queue.clear()


class BusyMapper:
    """The surface need_new_keyframe reads, with a mapper that is never
    idle."""

    def __init__(self, inner):
        self.inner = inner
        self.queue = []
        self.interrupts = 0
        self._busy = False
        self._expanding = False
        self.is_async = True

    def accepting(self):
        return False

    def interrupt_ba(self):
        self.interrupts += 1


def _timed_decision(tr, busy, ema, release_on_expansion=True):
    """need_new_keyframe with the queue full and a helper that drains it:
    queue and _expanding go after 0.25 s, _busy 0.25 s later. Returns
    (admitted, seconds)."""
    tr._inl_ema = ema
    tr.kf_drain_release_on_expansion = release_on_expansion
    busy.queue = [object()] * 3
    busy._busy = busy._expanding = True
    lock_free = []

    def drain():
        time.sleep(0.25)
        # The waiting decision must have released arena.lock.
        got = tr.arena.lock.acquire(timeout=5.0)
        lock_free.append(got)
        if got:
            tr.arena.lock.release()
        busy.queue.clear()
        busy._expanding = False
        time.sleep(0.25)
        busy._busy = False

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    t0 = time.monotonic()
    with tr.arena.lock:
        got = tr.need_new_keyframe()
    dt = time.monotonic() - t0
    th.join(10.0)
    assert not th.is_alive() and lock_free == [True]
    return got, dt


def test_bounded_queue_keyframe_admission(async16):
    tr = async16[0].tracker
    assert tr.state == TrackingState.OK
    busy = BusyMapper(tr.local_mapper)
    tr.local_mapper = busy
    try:
        # Inliers under 90% of the reference keyframe's tracked points.
        tr.n_inliers = 16
        tr.kf_async_wait_s = 0.0        # drop on a full queue
        for _ in range(5):
            if tr.need_new_keyframe():
                busy.queue.append(object())
        assert len(busy.queue) == 3 and busy.interrupts >= 5
        tr.kf_async_queue = None        # upstream monocular: drop when busy
        assert tr.need_new_keyframe() is False
        tr.kf_async_queue, tr.kf_async_wait_s = 3, 10.0
        # Healthy frame (16 >= 0.8 x 10): released at the expansion.
        got, dt = within(30, _timed_decision, tr, busy, 10.0)
        assert got is True and 0.2 <= dt < 0.45, dt
        assert tr.kf_wait_stats["waits"] >= 1
        assert tr.kf_wait_stats["timeouts"] == 0
        # Fragile frame (16 < 0.8 x 100): waits for the idle worker.
        got, dt = within(30, _timed_decision, tr, busy, 100.0)
        assert got is True and 0.45 <= dt < 5.0, dt
        assert tr.kf_wait_stats["full_drains"] >= 1
        # The full-drain knob waits for the idle worker as well.
        got, dt = within(30, _timed_decision, tr, busy, 10.0, False)
        assert got is True and 0.45 <= dt < 5.0, dt
        tr.kf_drain_release_on_expansion = True
        # Nothing drains: the demand is dropped after the bound.
        tr.kf_async_wait_s = 0.3
        busy.queue = [object()] * 3
        t0 = time.monotonic()
        assert within(30, tr.need_new_keyframe) is False
        assert time.monotonic() - t0 < 2.0
        assert tr.kf_wait_stats["timeouts"] == 1
    finally:
        tr.local_mapper = busy.inner


def test_internal_reset_under_lock_does_not_deadlock(async16):
    """Tracker.reset from inside the locked frame (the <= 5-keyframe LOST
    path) releases arena.lock around the worker flush."""
    slam = async16[0]
    mapper = slam.local_mapper
    mapper.start_async()

    def reset_under_lock():
        with slam.arena.lock:
            mapper.insert_keyframe(next(iter(slam.arena.kfs)))
            time.sleep(0.1)          # the worker now waits for the lock
            t0 = time.monotonic()
            slam.tracker.reset()
            return time.monotonic() - t0

    try:
        dt = within(60, reset_under_lock)
        assert dt < 20.0, dt
        assert not mapper.queue
        assert slam.arena.n_keyframes() == 0
        assert mapper.worker_errors == 0
    finally:
        within(30, mapper.stop_async)
    assert mapper._thread is None


def _rigid_map_rewrite(arena, yaw=0.35, shift=(0.8, -0.5, 0.4)):
    """Move the whole map by p' = Rg p + tg (Tcw' = Tcw Tg^-1), as a loop
    correction or a global-BA apply does, and count it in pose_epoch."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    Rg = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]], np.float32)
    tg = np.asarray(shift, np.float32)
    Tg_inv = np.eye(4, dtype=np.float32)
    Tg_inv[:3, :3] = Rg.T
    Tg_inv[:3, 3] = -Rg.T @ tg
    with arena.lock:
        for kf in arena.kfs.values():
            kf.Tcw = (kf.Tcw @ Tg_inv).astype(np.float32)
        for mp in arena.mps.values():
            arena.set_point_pos(mp, Rg @ mp.pos + tg)
            mp.normal = (Rg @ mp.normal).astype(np.float32)
        arena.pose_epoch += 1


def test_pipelined_survives_global_pose_rewrite():
    n, rewrite_at = 32, 20
    cfg = make_config(320, 240, N_FEATURES)
    frames, _ = render_sequence(cfg, n)
    slam = System(cfg, device="cpu")
    states = []

    def gen():
        for i, img in enumerate(frames):
            if i == rewrite_at:
                # Between two enqueues, as a global-BA apply lands: the
                # steps in flight ran on the old map.
                _rigid_map_rewrite(slam.arena)
            yield img, i / 30.0

    for _ in slam.track_monocular_pipelined(gen()):
        states.append(slam.get_tracking_state())
    slam.shutdown()
    assert len(states) == n
    post = states[rewrite_at:]
    n_ok = sum(s == TrackingState.OK for s in post)
    assert n_ok >= len(post) - 1, [s.name for s in post]
    assert states[-1] == TrackingState.OK
    assert slam.arena.pose_epoch == 1
    assert slam.tracker.chain_stats["accept"] > 0
    assert slam.tracker.epoch_violations == 0


def test_pipelined_classic_keyframes_resync_and_depth(monkeypatch):
    """The pipelined mode's knobs: depth 3 frames in flight,
    chain_classic_kf (a keyframe frame is tracked again classically, the
    state kept), and resync_every (the device state rebuilt from the host
    every 4 frames)."""
    n = 16
    cfg = make_config(320, 240, N_FEATURES)
    frames, poses = render_sequence(cfg, n)
    slam = System(cfg, device="cpu")
    tr = slam.tracker
    tr.chain_classic_kf = True
    bootstraps = []
    original = tr.chain_bootstrap
    monkeypatch.setattr(tr, "chain_bootstrap",
                        lambda: bootstraps.append(1) or original())
    n_yield = sum(1 for _ in slam.track_monocular_pipelined(
        ((img, i / 30.0) for i, img in enumerate(frames)), resync_every=4,
        depth=3))
    slam.shutdown()
    assert n_yield == n
    recs = slam.telemetry.records
    assert sum(r["state"] == int(TrackingState.OK) for r in recs) >= n - 2
    st = tr.chain_stats
    assert st["kf"] >= 1 and st["accept"] >= 1, st
    assert len(bootstraps) >= 3
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}
    est = traj_io.frame_poses(slam.arena, tr.trajectory)
    assert traj_io.ate_rmse(est, gt) < 0.03
