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
import torch

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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---- maps on disk (tests/test_reloc_loop.py:79-105 on the port) ------------

def _assert_arena_read_back(arena, jarena):
    """jarena (the JAX package's load_map of a file the port wrote) holds
    arena's ids, records, observations and topology, and its arrays."""
    assert (jarena.next_kf_id, jarena.next_mp_id, jarena.kf_origin_id) == \
        (arena.next_kf_id, arena.next_mp_id, arena.kf_origin_id)
    assert sorted(jarena.kfs) == sorted(arena.kfs)
    assert sorted(jarena.mps) == sorted(arena.mps)
    for k, kf in arena.kfs.items():
        jkf = jarena.kfs[k]
        n = kf.feats.n_slots
        assert (jkf.frame_id, jkf.timestamp, jkf.parent) == \
            (kf.frame_id, kf.timestamp, kf.parent)
        assert jkf.covis == kf.covis and jkf.loop_edges == kf.loop_edges
        assert jkf.children == {c for c in kf.children if c in arena.kfs}
        np.testing.assert_array_equal(jkf.Tcw, kf.Tcw)
        np.testing.assert_array_equal(jkf.mp_ids[:n], kf.mp_ids)
        assert (jkf.mp_ids[n:] == -1).all() and not jkf.feats.valid[n:].any()
        for f in ("xy", "xy_und", "response", "angle", "octave", "desc",
                  "valid", "u_right", "depth"):
            a, b = getattr(kf.feats, f), getattr(jkf.feats, f)
            if a is None:
                assert b is None, f
            else:
                np.testing.assert_array_equal(b[:n], a, err_msg=f)
        np.testing.assert_array_equal(jkf.node_ids[:n], kf.node_ids)
    for m, mp in arena.mps.items():
        jmp = jarena.mps[m]
        assert jmp.obs == mp.obs
        assert (jmp.min_dist, jmp.max_dist, jmp.ref_kf, jmp.first_kf_id,
                jmp.n_visible, jmp.n_found) == (
            mp.min_dist, mp.max_dist, mp.ref_kf, mp.first_kf_id,
            mp.n_visible, mp.n_found)
        for f in ("pos", "desc", "normal"):
            np.testing.assert_array_equal(getattr(jmp, f), getattr(mp, f))


def test_port_map_read_by_jax(systems, tmp_path):
    """System.save_map writes the format the JAX package reads: its
    load_map gives the port arena's ids, observations, covisibility, loop
    edges and parents, and its arrays, padded slots included. A keyframe's
    stereo channels (u_right / depth, format v2) cross too."""
    from orb_slam_system_tpu.mapping import serialize as jserialize
    from orb_slam_system_tpu_torch.mapping import serialize

    port = systems[0]
    path = str(tmp_path / "port_map.npz")
    port.save_map(path)
    slots = {kf.feats.n_slots for kf in port.arena.kfs.values()}
    assert len(slots) == 2          # the init keyframes' 2x slots padded
    _assert_arena_read_back(port.arena, jserialize.load_map(path))
    arena = serialize.load_map(path)
    kf = arena.kfs[max(arena.kfs)]
    rng = np.random.default_rng(0)
    kf.feats.u_right = np.where(kf.feats.valid, rng.uniform(
        10, 300, kf.feats.n_slots), -1.0).astype(np.float32)
    kf.feats.depth = np.where(kf.feats.u_right >= 0, 2.0, -1.0).astype(
        np.float32)
    serialize.save_map(arena, path)
    _assert_arena_read_back(arena, jserialize.load_map(path))


def _localize(slam, frames, first):
    """Track frames[first], frames[first + 1], frames[first + 2] on a
    loaded map; returns their poses."""
    return [slam.track_monocular(frames[i], 200.0 + i)
            for i in range(first, first + 3)]


def test_jax_map_localizes_in_port(systems, tmp_path):
    """The JAX System's saved map loads into a fresh port System on the
    CPU, and frame 12's view localizes against it without a new keyframe
    (tests/test_reloc_loop.py:79-105's bar: OK, centre within 0.08 of the
    pose JAX tracked for that frame)."""
    from orb_slam_system_tpu.dataio.trajectory import frame_poses

    port, jslam, frames = systems[:3]
    path = str(tmp_path / "jax_map.npz")
    jslam.save_map(path)
    slam = System(port.cfg, device="cpu")
    slam.load_map(path, localization_only=True)
    n_kf = jslam.arena.n_keyframes()
    assert slam.arena.n_keyframes() == n_kf
    assert slam.arena.n_points() == jslam.arena.n_points()
    for mp in slam.arena.mps.values():
        for kf_id, idx in mp.obs.items():
            if kf_id in slam.arena.kfs:
                assert slam.arena.kfs[kf_id].mp_ids[idx] == mp.id
    assert slam.place_rec.ready and slam.tracker.only_tracking
    Tcw = slam.track_monocular(frames[12], 200.0)
    assert slam.get_tracking_state() == TrackingState.OK and Tcw is not None
    assert slam.arena.n_keyframes() == n_kf
    fp = frame_poses(jslam.arena, jslam.tracker.trajectory)
    T_ref = next(T for ts, T, lost in fp
                 if abs(ts - 12 / 30.0) < 1e-9 and not lost)
    assert np.linalg.norm(_centre(Tcw) - _centre(T_ref)) < 0.08


def test_load_into_used_system_equals_fresh(systems, tmp_path):
    """Fault 3 of the JAX System.load_map: a load into a System that has
    tracked (its own map, caches on (keyframe ids, version), trajectory,
    self-trained vocabulary) gives what a load into a fresh System gives,
    frame for frame; and the old map leaves nothing behind."""
    port, jslam, frames = systems[:3]
    path = str(tmp_path / "map.npz")
    jslam.save_map(path)
    fresh = System(port.cfg, device="cpu")
    fresh.load_map(path)
    version, epoch = port.arena.version, port.arena.pose_epoch
    port.load_map(path)
    assert port.arena.version > version and port.arena.pose_epoch > epoch
    assert not port.arena.dead_kfs and not port.arena.dead_mps
    assert port.tracker.trajectory == [] and port.tracker.last_frame is None
    assert port.loop_closer.consistent_groups == []
    assert port.place_rec.db.bows == fresh.place_rec.db.bows
    got, want = _localize(port, frames, 12), _localize(fresh, frames, 12)
    for T, T_fresh in zip(got, want):
        assert T is not None and T_fresh is not None
        np.testing.assert_allclose(T, T_fresh, atol=1e-4)
    assert port.get_tracking_state() == fresh.get_tracking_state() == \
        TrackingState.OK
    assert port.arena.n_keyframes() == fresh.arena.n_keyframes() == \
        jslam.arena.n_keyframes()
