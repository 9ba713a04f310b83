"""The port's multi-sequence mode on the CPU against the JAX package's
(BASELINE.json config 5): the batched pack, the batched pose LM, the
batched front-end step, and S full Systems on one batched extraction.

Criteria: the batched pack as tests/test_torch_extractor.py holds the
extractor (identical valid keypoint sets, descriptor bits equal off
angle-bin flips, <= 1% flips), and every row equal to the single-image
pack exactly; the batched LM within 1e-4 of jax.vmap(pose_optimization)
with equal inliers, and within 1e-5 of the port's unbatched call per row;
the front-end step's totals equal to the JAX step's and its poses within
1e-4 (tests/test_parallel.py's tolerance); per sequence of a 2-sequence
run_full, the initialization frame, frames tracked, keyframes, points and
final state equal to the JAX MultiSystem's, the ATE within 1 cm of it
(tests/test_torch_system_mono.py's bar).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.config import (CameraConfig as JCameraConfig,
                                        ORBConfig as JORBConfig,
                                        SlamConfig as JSlamConfig)
from orb_slam_system_tpu.models.frame import FrameBuilder as JFrameBuilder
from orb_slam_system_tpu.ops.brief import _angle_bins as j_bins
from orb_slam_system_tpu.ops.extractor import ORBExtractor as JExtractor
from orb_slam_system_tpu.parallel.multiseq import (
    make_mesh, make_multiseq_step as j_make_step)
from orb_slam_system_tpu.solvers.pose_opt import (
    pose_optimization as j_pose_optimization)
from orb_slam_system_tpu_torch.config import TrackingState
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.drivers import multiseq_throughput
from orb_slam_system_tpu_torch.drivers.mono_synthetic import make_config
from orb_slam_system_tpu_torch.models.frame import FrameBuilder
from orb_slam_system_tpu_torch.ops.brief import _angle_bins
from orb_slam_system_tpu_torch.parallel import multiseq
from orb_slam_system_tpu_torch.parallel.multi_system import MultiSystem
from orb_slam_system_tpu_torch.solvers.pose_opt import (
    pose_optimization, pose_optimization_batch)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N_SEQ, N_FRAMES, N_FEATURES = 2, 12, 400


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as the other System test files run (the
    Tier-1 command's workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _views(S, h=96, w=128):
    """S seeded u8 views at 96x128: texture seed s, orbit pose s."""
    cfg = make_config(w, h, 256)
    poses = orbit_trajectory(S, radius=0.35, depth=-2.0, tilt=0.3)
    imgs = [PlanarSceneRenderer(cfg.camera.K, w, h,
                                texture=make_texture(1024, 8, seed=s),
                                tex_scale=220.0 * w / 320).render(poses[s])
            for s in range(S)]
    return cfg, np.clip(np.stack(imgs), 0, 255).astype(np.uint8)


def test_batched_pack_matches_jax_and_single_packs():
    cfg, imgs = _views(3)
    c = cfg.camera
    jcfg = JSlamConfig(camera=JCameraConfig(
        fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, fps=30.0, width=c.width,
        height=c.height), orb=JORBConfig(n_features=256))
    jp = np.asarray(JFrameBuilder(jcfg)._extract_packed_batch(
        jnp.asarray(imgs)))
    fb = FrameBuilder(cfg, "cpu")
    pp = fb.extract_packed_batch(imgs)
    assert pp.shape == jp.shape == (3, fb.extractor.n_slots, 16)
    for s in range(3):
        # Bit patterns: descriptor words seen as f32 can be NaNs.
        assert torch.equal(pp[s].view(torch.int32),
                           fb.extract_packed(imgs[s]).view(torch.int32)), s
        p, j = pp[s].numpy(), jp[s]
        vp, vj = p[:, 7] > 0.5, j[:, 7] > 0.5
        assert vj.sum() > 50
        np.testing.assert_array_equal(vp, vj)
        np.testing.assert_array_equal(p[:, 0:2], j[:, 0:2])      # xy
        np.testing.assert_array_equal(p[:, 6], j[:, 6])          # octave
        np.testing.assert_allclose(p[:, 2:4], j[:, 2:4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(p[:, 4], j[:, 4], rtol=0, atol=1e-3)
        flips = (_angle_bins(torch.from_numpy(p[None, :, 5])).numpy()[0]
                 != np.asarray(j_bins(jnp.asarray(j[None, :, 5])))[0]) & vj
        assert flips.sum() <= 0.01 * vj.sum(), f"{flips.sum()} angle-bin flips"
        desc_p = np.ascontiguousarray(p[:, 8:16]).view(np.uint32)
        desc_j = np.ascontiguousarray(j[:, 8:16]).view(np.uint32)
        off = (desc_p != desc_j).any(1) & vj & ~flips
        assert not off.any(), f"{off.sum()} descriptors differ off flips"


def _lm_problems(S=3, N=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (S, N, 3)).astype(np.float32)
    X[..., 2] += 4.0
    T_true = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    T_true[:, :3, 3] = rng.normal(0, 0.05, (S, 3))
    Xc = X + T_true[:, None, :3, 3]
    uv = (Xc[..., :2] / Xc[..., 2:3] * 100.0 + 64.0
          + rng.normal(0, 0.5, (S, N, 2))).astype(np.float32)
    uv[:, :6] += 40.0                               # outliers
    T0 = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    inv_sigma2 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], (S, N)).astype(
        np.float32)
    valid = rng.random((S, N)) > 0.1
    return T0, X, uv, inv_sigma2, valid


def test_batched_pose_lm_matches_jax_vmap_and_single_calls():
    args = _lm_problems()
    cam = (100.0, 100.0, 64.0, 64.0)
    T, inl, n_in = pose_optimization_batch(
        *[torch.from_numpy(a) for a in args], *cam)
    jT, jinl, jn = jax.vmap(
        lambda T0, X, uv, w, ok: j_pose_optimization(T0, X, uv, w, ok, *cam)
    )(*[jnp.asarray(a) for a in args])
    assert T.shape == (3, 4, 4) and inl.shape == (3, 64) and n_in.shape == (3,)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    np.testing.assert_array_equal(n_in.numpy(), np.asarray(jn))
    assert (n_in.numpy() > 40).all() and not inl[:, :6].any()
    for s in range(3):
        Ts, inls, ns = pose_optimization(
            *[torch.from_numpy(a[s]) for a in args], *cam)
        torch.testing.assert_close(T[s], Ts, rtol=0, atol=1e-5)
        assert torch.equal(inl[s], inls) and int(n_in[s]) == int(ns)


def test_frontend_step_matches_jax():
    jstep, jargs = j_make_step(make_mesh(1), 96, 128, n_features=128,
                               n_levels=2)
    step, args = multiseq.make_multiseq_step(96, 128, n_features=128,
                                             n_levels=2, n_sequences=2,
                                             device="cpu")
    # The example arguments are the JAX step's, draw for draw.
    for a, ja in zip(args, jargs):
        ja = np.asarray(ja)
        if ja.dtype == np.uint32:
            ja = ja.view(np.int32)
        np.testing.assert_array_equal(a.numpy(), ja)
    jT, jn_in, jn_match = jstep(*jargs)
    T, n_in, n_match = step(*args)
    assert int(n_match) == int(jn_match) and int(n_in) == int(jn_in)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0, atol=1e-4)
    # A tracked state: the previous descriptors are this frame's own (JAX's
    # extraction), the points the keypoints back-projected at depth 4 m
    # from a camera 2 cm off, so every valid keypoint matches and the LM
    # has edges to solve.
    _, imgs = _views(2)
    jfb = JExtractor(JORBConfig(n_features=128, n_levels=2), 96, 128)
    jf = jax.tree.map(np.array, jfb(jnp.asarray(imgs.astype(np.float32))))
    xy = jf.xy
    pts = np.concatenate([(xy - [64.0, 48.0]) / (0.8 * 128) * 4.0,
                          np.full(xy.shape[:2] + (1,), 4.0)], -1)
    pts = (pts + [0.02, 0.0, 0.0]).astype(np.float32)
    Tcw0 = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    state = (jf.desc, jf.valid, pts, Tcw0)
    jT, jn_in, jn_match = jstep(jnp.asarray(imgs.astype(np.float32)),
                                *[jnp.asarray(a) for a in state])
    T, n_in, n_match = step(imgs, *state)
    assert int(jn_match) > 100 and int(jn_in) > 100
    assert abs(int(n_match) - int(jn_match)) <= 0.01 * int(jn_match)
    assert abs(int(n_in) - int(jn_in)) <= 0.01 * int(jn_in)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0, atol=1e-4)


def _per_sequence(systems, telemetry_states):
    """(init frame, frames tracked, keyframes, points, final state) per
    System."""
    ok = int(TrackingState.OK)
    out = []
    for sy, states in zip(systems, telemetry_states):
        out.append((states.index(ok), sum(1 for s in states if s == ok),
                    sy.arena.n_keyframes(), sy.arena.n_points(),
                    int(sy.tracker.state)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' run_full(2, 12, 400) (test_multiseq_system.py's
    scenes), the port's with its extraction calls counted per round."""
    from examples.multiseq_throughput import run_full as j_run_full

    rounds = []            # (steady sequences, batched extractions) per round
    calls = [0]
    orig_track = MultiSystem.track_batch
    orig_extract = FrameBuilder.extract_packed_batch

    def track_batch(self, imgs, ts):
        n0 = calls[0]
        steady = sum(sy.tracker.state not in (TrackingState.NO_IMAGES_YET,
                                              TrackingState.NOT_INITIALIZED)
                     for sy in self.systems)
        poses = orig_track(self, imgs, ts)
        rounds.append((steady, calls[0] - n0))
        return poses

    def extract(self, imgs):
        calls[0] += 1
        return orig_extract(self, imgs)

    out = tmp_path_factory.mktemp("multiseq")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MultiSystem, "track_batch", track_batch)
        mp.setattr(FrameBuilder, "extract_packed_batch", extract)
        ms, ates, fps = multiseq_throughput.run_full(
            N_SEQ, N_FRAMES, str(out), N_FEATURES, verbose=False,
            device="cpu")
    jms, jates, _ = j_run_full(N_SEQ, N_FRAMES, str(tmp_path_factory.mktemp(
        "jax_multiseq")), N_FEATURES, verbose=False)
    return dict(ms=ms, ates=ates, fps=fps, out=out, rounds=rounds, jms=jms,
                jates=jates)


def test_run_full_matches_jax_per_sequence(runs):
    ms, jms = runs["ms"], runs["jms"]
    port = _per_sequence(ms.systems, [[r["state"] for r in sy.telemetry.records]
                                      for sy in ms.systems])
    jax_ = _per_sequence(jms.systems, [[r["state"] for r in
                                        sy.telemetry.records]
                                       for sy in jms.systems])
    assert port == jax_, (port, jax_)
    for s, (a, ja) in enumerate(zip(runs["ates"], runs["jates"])):
        assert ja < 0.05 and a < 0.05, s
        assert abs(a - ja) < 0.01, (s, a, ja)


def test_run_full_bars(runs):
    """tests/test_multiseq_system.py's bars, on the port."""
    ms = runs["ms"]
    for s, sy in enumerate(ms.systems):
        assert sy.get_tracking_state() == TrackingState.OK, s
        assert sy.arena.n_keyframes() >= 3, s
        assert sy.arena.n_points() > 100, s
        assert len(sy.telemetry.records) == N_FRAMES
    assert runs["fps"] > 0 and len(ms.frame_ms) == N_FRAMES


def test_shared_extraction_once_per_steady_round(runs):
    rounds = runs["rounds"]
    assert len(rounds) == N_FRAMES
    assert all(n == (1 if steady else 0) for steady, n in rounds), rounds
    assert sum(1 for steady, _ in rounds if steady) >= N_FRAMES // 2


def test_frame_ids_per_sequence(runs):
    """Each System numbers its steady frames from its own builder, one id
    per round it tracked from the shared batch."""
    for sy in runs["ms"].systems:
        n_init = sy.tracker.init_builder._next_id
        assert sy.tracker.builder._next_id == N_FRAMES - n_init
        assert sy.tracker.last_frame.id == N_FRAMES - n_init - 1


def test_one_trajectory_file_per_sequence(runs):
    for s in range(N_SEQ):
        p = runs["out"] / f"CameraTrajectory_seq{s}.txt"
        assert p.exists() and len(p.read_text().splitlines()) > 10


def test_reset_sequence_reinitializes_on_its_own():
    """A sequence reset mid-run goes back to its own track_monocular (the
    2x-features builder) while the other stays on the shared extraction,
    which then packs only the steady row (the JAX class extracts all S
    rows); its frame ids run on across both routes."""
    cam = multiseq_throughput.default_camera()
    cfg = make_config(cam.width, cam.height, N_FEATURES)
    renderers, trajs = multiseq_throughput.sequence_scenes(2, 10, cam)
    ms = MultiSystem(cfg, 2, device="cpu")
    rows = []
    orig = ms.shared_builder.extract_packed_batch

    def extract(imgs):
        rows.append(imgs.shape[0])
        return orig(imgs)

    ms.shared_builder.extract_packed_batch = extract
    for i in range(10):
        if i == 4:
            assert all(sy.get_tracking_state() == TrackingState.OK
                       for sy in ms.systems)
            ms.systems[1].reset()
            n_rows = len(rows)
        ms.track_batch(np.stack([r.render(t[i])
                                 for r, t in zip(renderers, trajs)]), i / 30.0)
    ms.shutdown()
    assert rows[n_rows] == 1                    # sequence 0 alone, at frame 4
    assert rows[-1] == 2                        # both steady again
    assert all(sy.get_tracking_state() == TrackingState.OK
               for sy in ms.systems)
    for sy in ms.systems:
        tr = sy.tracker
        assert tr.builder._next_id + tr.init_builder._next_id == 10
    states = [r["state"] for r in ms.systems[1].telemetry.records]
    assert states[4] == int(TrackingState.NOT_INITIALIZED)
