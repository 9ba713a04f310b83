"""The slice as a whole against the JAX package on the CPU: frames built by
each side's FrameBuilder, tracked from the same seeded map by
fused_track_step through each side's TrackPrograms (local_slots=512).

Tolerances: pose atol 1e-3, match and inlier counts within +-2.
"""

import numpy as np
import pytest
import torch

from orb_slam_system_tpu.config import CameraConfig as JCameraConfig
from orb_slam_system_tpu.config import ORBConfig as JORBConfig
from orb_slam_system_tpu.config import SlamConfig as JSlamConfig
from orb_slam_system_tpu.mapping.arena import MapArena
from orb_slam_system_tpu.models.frame import FrameBuilder as JFrameBuilder
from orb_slam_system_tpu.models.track_device import TrackPrograms as JTrackPrograms
from orb_slam_system_tpu_torch.config import CameraConfig, ORBConfig, SlamConfig
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.models.frame import FrameBuilder
from orb_slam_system_tpu_torch.models.track_device import TrackPrograms
from orb_slam_system_tpu_torch.models.tracking import (fused_track_step,
                                                       seed_map_from_depth)
from orb_slam_system_tpu_torch.utils.interop import packed_frame_from_numpy

W, H, N_FEATURES, LOCAL_SLOTS = 320, 240, 500, 512
CAM = dict(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, fps=30.0, width=W, height=H)


@pytest.fixture(scope="module")
def scene():
    cam = CameraConfig(**CAM)
    r = PlanarSceneRenderer(cam.K, W, H, texture=make_texture(2048, 8, 7),
                            tex_scale=440.0)
    poses = orbit_trajectory(30, radius=0.35, depth=-2.0, tilt=0.3)[:6]
    frames = [np.clip(r.render(T), 0, 255).astype(np.uint8) for T in poses]
    return cam, r, poses, frames


@pytest.fixture(scope="module")
def jax_side(scene):
    cam, r, poses, frames = scene
    cfg = JSlamConfig(camera=JCameraConfig(**CAM),
                      orb=JORBConfig(n_features=N_FEATURES))
    fb = JFrameBuilder(cfg)
    built = [fb.build(f, i / 30.0) for i, f in enumerate(frames)]
    programs = JTrackPrograms(cfg, fb.extractor.n_slots, LOCAL_SLOTS, fb.bounds)
    return fb, programs, built


@pytest.fixture(scope="module")
def port_side(scene):
    cam, r, poses, frames = scene
    cfg = SlamConfig(camera=CameraConfig(**CAM),
                     orb=ORBConfig(n_features=N_FEATURES))
    fb = FrameBuilder(cfg, "cpu")
    built = [fb.build(f, i / 30.0) for i, f in enumerate(frames)]
    programs = TrackPrograms(cfg, fb.extractor.n_slots, LOCAL_SLOTS, fb.bounds,
                             "cpu")
    return fb, programs, built


def _track(programs, packed, local_map, mp_ids, T0, cam):
    results = []
    last_T, last_ids = T0, mp_ids
    velocity = np.eye(4, dtype=np.float32)
    for i in range(1, len(packed)):
        res = fused_track_step(programs, packed[i - 1], packed[i], last_T,
                               last_ids, velocity, local_map, cam)
        assert res is not None, f"frame {i} rejected"
        results.append(res)
        velocity = (res.Tcw @ np.linalg.inv(last_T)).astype(np.float32)
        last_T, last_ids = res.Tcw, res.mp_ids
    return results


def test_frames_match(jax_side, port_side):
    """Packed frames: keypoint columns equal, descriptor words bit-equal."""
    for fj, fp in zip(jax_side[2], port_side[2]):
        pj = np.asarray(fj.packed_dev)
        pp = fp.packed.numpy()
        np.testing.assert_array_equal(pp[:, [0, 1, 6, 7]], pj[:, [0, 1, 6, 7]])
        np.testing.assert_allclose(pp[:, 2:6], pj[:, 2:6], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(pp[:, 8:16].view(np.uint32),
                                      pj[:, 8:16].view(np.uint32))
        # The interop path carries the bit-cast columns unchanged.
        back = packed_frame_from_numpy(pj, "cpu").numpy()
        np.testing.assert_array_equal(back.view(np.uint32), pj.view(np.uint32))


def test_seed_map_matches_arena(scene, port_side):
    """seed_map_from_depth's normals and distance band equal the JAX arena's
    update_normal_and_depth for a single observation."""
    cam, r, poses, _ = scene
    fb, _, built = port_side
    feats = built[0].feats
    T0 = poses[0].astype(np.float32)
    lm, mp_ids = seed_map_from_depth(feats, T0, r.render_depth(poses[0]), cam,
                                     fb.scale_factors, LOCAL_SLOTS)
    k = len(lm.ids)
    assert k > 300 and lm.valid[:k].all() and not lm.valid[k:].any()
    arena = MapArena()
    kf = arena.new_keyframe(0, 0.0, T0, feats)
    for p in range(0, k, 7):
        slot = int(np.nonzero(mp_ids == p)[0][0])
        mp = arena.new_point(lm.pos[p], lm.desc[p], kf.id, kf.id)
        arena.add_observation(mp, kf, slot)
        arena.update_normal_and_depth(mp, fb.scale_factors)
        np.testing.assert_allclose(lm.normal[p], mp.normal, rtol=0, atol=1e-6)
        np.testing.assert_allclose(lm.mind[p], 0.8 * mp.min_dist, rtol=1e-6)
        np.testing.assert_allclose(lm.maxd[p], 1.2 * mp.max_dist, rtol=1e-6)
    # Every point projects back onto its feature at the seeding pose.
    Xc = lm.pos[:k] @ T0[:3, :3].T + T0[:3, 3]
    uv = Xc[:, :2] / Xc[:, 2:] * [cam.fx, cam.fy] + [cam.cx, cam.cy]
    slots = np.argsort(mp_ids)[-k:]
    np.testing.assert_allclose(uv, feats.xy_und[slots], atol=1e-2)


def test_slice_matches_jax(scene, jax_side, port_side):
    cam, r, poses, _ = scene
    jfb, jprog, jbuilt = jax_side
    pfb, pprog, pbuilt = port_side
    T0 = poses[0].astype(np.float32)
    # One seeded map for both sides (their frame-0 features are equal).
    lm, mp_ids = seed_map_from_depth(
        JFrameBuilder._unpack_feats(np.asarray(jbuilt[0].packed_dev)), T0,
        r.render_depth(poses[0]), cam, pfb.scale_factors, LOCAL_SLOTS)
    res_j = _track(jprog, [f.packed_dev for f in jbuilt], lm, mp_ids, T0, cam)
    res_p = _track(pprog, [f.packed for f in pbuilt], lm, mp_ids, T0, cam)
    for i, (a, b) in enumerate(zip(res_j, res_p), start=1):
        np.testing.assert_allclose(b.Tcw, a.Tcw, rtol=0, atol=1e-3)
        for name in ("n_matched", "n_in1", "n_in2"):
            assert abs(getattr(a, name) - getattr(b, name)) <= 2, (i, name)
        assert b.n_in2 >= 100
        C = -b.Tcw[:3, :3].T @ b.Tcw[:3, 3]
        C_gt = -poses[i][:3, :3].T @ poses[i][:3, 3]
        assert np.linalg.norm(C - C_gt) < 0.03


@pytest.mark.parametrize("step", ["motion_step", "localmap_step"])
def test_fallback_steps_match_jax(scene, jax_side, port_side, step):
    """The tracker's two-step fallback programs on frame 0 -> 1 of the
    seeded map, each side on its own packed frames: pose within 1e-3,
    match and inlier counts within 3% (the LM reclassifies edges whose chi2
    sits near 5.991, where float32 sums in another order flip a few),
    associations equal on >= 99% of rows."""
    cam, r, poses, _ = scene
    _, jprog, jbuilt = jax_side
    pfb, pprog, pbuilt = port_side
    T0 = poses[0].astype(np.float32)
    lm, mp_ids = seed_map_from_depth(
        JFrameBuilder._unpack_feats(np.asarray(jbuilt[0].packed_dev)), T0,
        r.render_depth(poses[0]), cam, pfb.scale_factors, LOCAL_SLOTS)
    n = len(mp_ids)
    if step == "motion_step":
        ok = mp_ids >= 0
        pos = np.zeros((n, 3), np.float32)
        pos[ok] = lm.pos[mp_ids[ok]]
        Xc = pos @ T0[:3, :3].T + T0[:3, 3]
        proj = (Xc[:, :2] / np.where(ok, Xc[:, 2], 1.0)[:, None]
                * [cam.fx, cam.fy] + [cam.cx, cam.cy]).astype(np.float32)
        args = (proj, ok, pos)
        outs = [prog.motion_step(*args, b[0], b[1], T0) for prog, b in
                ((jprog, [f.packed_dev for f in jbuilt]),
                 (pprog, [f.packed for f in pbuilt]))]
        (Tj, bj, mj, _, nj, nmj, nvj), (Tp, bp, mp, _, np_, nmp, nvp) = outs
        assert nvj == nvp and abs(nmj - nmp) <= 0.03 * nmj
        assert abs(nj - np_) <= 0.03 * nj
        assert ((bj == bp) | ~(mj & mp)).mean() >= 0.99
    else:
        args = (lm.pos, lm.normal, lm.mind, lm.maxd, lm.desc, lm.valid,
                np.zeros((n, 3), np.float32), np.zeros(n, bool))
        outs = [prog.localmap_step(*args, packed, np.zeros(n, bool), T0)
                for prog, packed in ((jprog, jbuilt[1].packed_dev),
                                     (pprog, pbuilt[1].packed))]
        (Tj, ij, vj, _, nj), (Tp, ip, vp, _, np_) = outs
        assert abs(nj - np_) <= 0.03 * nj and nj >= 100
        assert (ij == ip).mean() >= 0.99 and (vj == vp).mean() >= 0.99
    np.testing.assert_allclose(Tp, Tj, rtol=0, atol=1e-3)
