"""The slice as a whole: place recognition and relocalization of the port's
monocular System against the JAX System on the CPU.

Both systems track the same 25 rendered frames of the textured-plane orbit
at 320x240 with 400 features (tests/test_torch_system_mono.py's settings),
the JAX System with its default place recognition and its loop closer set
to None on the instance (the port has no loop closing). Then, on both:
  * the vocabulary each self-trained has the same number of words, and
    every keyframe's BoW dict and direct-index node ids are equal (exact:
    the descents are bit-equal and the dict sums run in the same order);
  * with the state forced to LOST, frame 10's view relocalizes to OK on the
    same reference keyframe; the port's pose is within 1e-3 (map units) and
    0.1 deg of JAX's, and its camera centre within 0.08 of the pose tracked
    for frame 10 (tests/test_reloc_loop.py's bar);
  * a view shifted by (5, 5, 0) m stays LOST, for the same reason
    (the same reloc_stats key);
  * with six decoy ids ahead of the real candidates, the port still
    relocalizes.
"""

import numpy as np
import pytest

from orb_slam_system_tpu.config import (CameraConfig as JCameraConfig,
                                        ORBConfig as JORBConfig,
                                        SlamConfig as JSlamConfig,
                                        TrackingState as JTrackingState)
from orb_slam_system_tpu.models.system import System as JSystem
from orb_slam_system_tpu_torch.config import TrackingState
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.drivers.mono_synthetic import (make_config,
                                                              make_renderer,
                                                              render_sequence)
from orb_slam_system_tpu_torch.models.system import System

N_FRAMES, N_FEATURES, MID = 25, 400, 10


@pytest.fixture(scope="module")
def systems():
    cfg = make_config(320, 240, N_FEATURES)
    frames, poses = render_sequence(cfg, N_FRAMES)
    c = cfg.camera
    jcfg = JSlamConfig(camera=JCameraConfig(
        fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, fps=30.0, width=c.width,
        height=c.height), orb=JORBConfig(n_features=N_FEATURES))
    port = System(cfg, device="cpu")
    jslam = JSystem(None, jcfg)
    jslam.local_mapper.loop_closer = None
    for i, img in enumerate(frames):
        port.track_monocular(img, i / 30.0)
        jslam.track_monocular(img, i / 30.0)
    # The pose the port tracked for frame MID, before any relocalization.
    fp = traj_io.frame_poses(port.arena, port.tracker.trajectory)
    tracked = next(T for ts, T, lost in fp
                   if abs(ts - MID / 30.0) < 1e-9 and not lost)
    return port, jslam, frames, poses, make_renderer(cfg), tracked


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def _rot_deg(Ra, Rb):
    M = Ra.astype(np.float64) @ Rb.astype(np.float64).T
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.degrees(np.arctan2(0.5 * s, 0.5 * (np.trace(M) - 1.0))))


def _force_lost(port, jslam):
    port.tracker.state = TrackingState.LOST
    jslam.tracker.state = JTrackingState.LOST
    port.tracker.velocity = jslam.tracker.velocity = None


def test_same_vocabulary_and_keyframe_bows(systems):
    port, jslam = systems[:2]
    assert port.place_rec.ready and jslam.place_rec.ready
    assert port.place_rec.vocab.n_words == jslam.place_rec.vocab.n_words > 50
    assert sorted(port.arena.kfs) == sorted(jslam.arena.kfs)
    for kf_id, kf in port.arena.kfs.items():
        jkf = jslam.arena.kfs[kf_id]
        assert kf.bow and kf.bow == jkf.bow
        np.testing.assert_array_equal(kf.node_ids, jkf.node_ids)
    assert port.place_rec.db.bows == jslam.place_rec.db.bows


def test_relocalizes_mid_orbit(systems):
    port, jslam, frames, _, _, tracked = systems
    _force_lost(port, jslam)
    T = port.track_monocular(frames[MID], 99.0)
    jT = jslam.track_monocular(frames[MID], 99.0)
    assert port.get_tracking_state() == TrackingState.OK
    assert jslam.get_tracking_state() == JTrackingState.OK
    assert port.tracker.ref_kf_id == jslam.tracker.ref_kf_id
    assert _rot_deg(T[:3, :3], jT[:3, :3]) < 0.1
    np.testing.assert_allclose(T[:3, 3], jT[:3, 3], atol=1e-3)
    assert np.linalg.norm(_centre(T) - _centre(tracked)) < 0.08
    assert port.tracker.reloc_stats == jslam.tracker.reloc_stats


def test_far_view_stays_lost(systems):
    port, jslam, _, poses, renderer, _ = systems
    T = poses[0].copy()
    T[:3, 3] += np.array([5.0, 5.0, 0.0])
    img = renderer.render(T)
    before = dict(port.tracker.reloc_stats), dict(jslam.tracker.reloc_stats)
    _force_lost(port, jslam)
    port.track_monocular(img, 100.0)
    jslam.track_monocular(img, 100.0)
    assert port.get_tracking_state() == TrackingState.LOST
    assert jslam.get_tracking_state() == JTrackingState.LOST
    moved = [{k for k, v in s.tracker.reloc_stats.items()
              if v != b.get(k, 0)} - {"attempts"}
             for s, b in zip((port, jslam), before)]
    assert moved[0] == moved[1] and len(moved[0]) == 1, moved


def test_decoy_candidates_first(systems, monkeypatch):
    """tests/test_reloc_loop.py::test_relocalization_uncapped_candidate_rank
    on the port: the real candidates sit behind six ids of no keyframe."""
    port, _, frames = systems[:3]
    db = port.place_rec.db
    orig = db.detect_reloc_candidates
    calls = {}

    def reordered(bow, arena):
        cands = orig(bow, arena)
        calls["list"] = [99991, 99992, 99993, 99994, 99995, 99996] + cands[::-1]
        return calls["list"]

    monkeypatch.setattr(db, "detect_reloc_candidates", reordered)
    port.tracker.state = TrackingState.LOST
    port.tracker.velocity = None
    Tcw = port.track_monocular(frames[MID], 300.0)
    assert len(calls["list"]) > 6
    assert port.get_tracking_state() == TrackingState.OK and Tcw is not None
