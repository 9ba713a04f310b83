"""The pipelined mode's device step and System against the JAX package on
the CPU.

  * TrackPrograms.chain_step, one call of each side on the same numpy
    inputs: the JAX package's packed frames (carried over bit for bit), a
    local block of 512 points seeded from frame 0's depths, an association
    with -1s into a permuted previous block, a remap with dropped rows, and
    a pose state a little off SO(3). Monocular (16 columns) and RGB-D (18
    columns, with stereo edges and the close-point counts). Criteria:
    T_cur and the projected T_last within 1e-4, the association, visible
    and already-local rows and the four counts (and the close-point
    counts) exactly. The port's step runs under a guard that fails on any
    read of a tensor back to the host.
  * lie.se3_project_np against the JAX one (1e-12).
  * The monocular System with synchronous mapping through
    track_monocular_pipelined, 30 frames of the 320x240 orbit, 400
    features, each package on the same rendered frames: one yield per
    frame in order, the same frames OK, the same keyframe count, chain
    accepts within 2, ATE within 0.5 cm of each other and < 3 cm. The
    port's chain_enqueue runs under the host-read guard.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.config import CameraConfig as JCameraConfig
from orb_slam_system_tpu.config import ORBConfig as JORBConfig
from orb_slam_system_tpu.config import Sensor as JSensor
from orb_slam_system_tpu.config import SlamConfig as JSlamConfig
from orb_slam_system_tpu.dataio import trajectory as jtraj
from orb_slam_system_tpu.models.frame import FrameBuilder as JFrameBuilder
from orb_slam_system_tpu.models.system import System as JSystem
from orb_slam_system_tpu.models.track_device import TrackPrograms as JTrackPrograms
from orb_slam_system_tpu.utils import lie as jlie
from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig, Sensor,
                                              SlamConfig, TrackingState)
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.drivers.mono_synthetic import (make_config,
                                                              render_sequence,
                                                              run)
from orb_slam_system_tpu_torch.models.track_device import TrackPrograms
from orb_slam_system_tpu_torch.models.tracking import seed_map_from_depth
from orb_slam_system_tpu_torch.utils import lie
from orb_slam_system_tpu_torch.utils.interop import (local_block_from_numpy,
                                                     packed_frame_from_numpy)

W, H, N_FEATURES, LOCAL_SLOTS = 320, 240, 400, 512
N_FRAMES = 30
CAM = dict(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, fps=30.0, width=W, height=H)
BF = 260.0 * 0.08


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these runs: the suite runs several workers on
    a shared machine, where the default pool (a thread per core in every
    worker) spins against the other workers. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def no_host_reads():
    """Fail on anything that reads a tensor's value back to the host or
    uploads a host value (on the card each of these waits for the stream):
    .item(), .tolist(), .numpy(), .cpu(), bool() / int() / float() of a
    tensor, nonzero / unique / masked_select, indexing with a boolean
    tensor, torch.tensor / as_tensor, and writing a Python number into a
    tensor by indexing."""
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"host sync inside the chain step: {name}")
        return f

    methods = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
               "__float__", "__index__", "nonzero", "unique", "masked_select")
    functions = ("nonzero", "unique", "masked_select", "tensor", "as_tensor")
    saved_m = {n: getattr(torch.Tensor, n) for n in methods}
    saved_f = {n: getattr(torch, n) for n in functions}
    get, put = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def bool_index(idx):
        items = idx if isinstance(idx, tuple) else (idx,)
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in items)

    def getitem(self, idx):
        if bool_index(idx):
            raise AssertionError("boolean indexing inside the chain step")
        return get(self, idx)

    def setitem(self, idx, value):
        if bool_index(idx):
            raise AssertionError("boolean indexing inside the chain step")
        if isinstance(value, (bool, int, float)):
            raise AssertionError("a Python number written into a tensor "
                                 "inside the chain step")
        return put(self, idx, value)

    try:
        for n in methods:
            setattr(torch.Tensor, n, refuse(n))
        for n in functions:
            setattr(torch, n, refuse(n))
        torch.Tensor.__getitem__, torch.Tensor.__setitem__ = getitem, setitem
        yield
    finally:
        for n, f in saved_m.items():
            setattr(torch.Tensor, n, f)
        for n, f in saved_f.items():
            setattr(torch, n, f)
        torch.Tensor.__getitem__, torch.Tensor.__setitem__ = get, put


def test_no_host_reads_guard_fires():
    """The guard catches what it is meant to catch."""
    x = torch.arange(4)
    with no_host_reads():
        y = torch.zeros(4)
        for read in (lambda: x.sum().item(), lambda: bool(x[0] > 1),
                     lambda: x[x > 1], lambda: x.cpu(),
                     lambda: y.__setitem__(0, 1.0), lambda: torch.tensor(1.0)):
            with pytest.raises(AssertionError):
                read()
        z = torch.where(x > 1, x, 0)
    assert torch.equal(z, torch.tensor([0, 0, 2, 3]))


@pytest.fixture(scope="module")
def chain_scene():
    """Three frames of the orbit (u8), their depth maps and true poses."""
    cam = CameraConfig(**CAM)
    r = PlanarSceneRenderer(cam.K, W, H, texture=make_texture(2048, 8, 7),
                            tex_scale=220.0)
    poses = orbit_trajectory(30, radius=0.35, depth=-2.0, tilt=0.3)[:3]
    frames = [np.clip(r.render(T), 0, 255).astype(np.uint8) for T in poses]
    depths = [r.render_depth(T).astype(np.float32) for T in poses]
    return cam, frames, depths, poses


def _chain_inputs(rng, cam, lm, mp_ids, poses):
    """State, previous block and remap around the seeded block `lm`."""
    P = LOCAL_SLOTS
    k = len(lm.ids)
    # The previous block held the same points in another order; 5% of its
    # rows left the block (remap -1), 10% of the slots had lost their point.
    perm = rng.permutation(k)                 # previous row r -> row perm[r]
    inv = np.argsort(perm)                    # row i -> previous row inv[i]
    remap = np.full(P, -1, np.int64)
    remap[:k] = perm
    remap[rng.random(P) < 0.05] = -1
    assoc = np.where(mp_ids >= 0, inv[np.maximum(mp_ids, 0)], -1)
    assoc[rng.random(len(assoc)) < 0.1] = -1
    T0, T1 = (p.astype(np.float64) for p in poses[:2])
    velocity = T1 @ np.linalg.inv(T0)
    T_last = T0.astype(np.float32)
    T_last[:3, :3] *= np.float32(1.002)       # off SO(3): se3_project fixes
    T_prev = (np.linalg.inv(velocity) @ T0).astype(np.float32)
    return T_prev, T_last, assoc, remap


@pytest.mark.parametrize("sensor", ["monocular", "rgbd"])
def test_chain_step_matches_jax(chain_scene, sensor):
    cam, frames, depths, poses = chain_scene
    rgbd = sensor == "rgbd"
    extra = dict(bf=BF) if rgbd else {}
    jcfg = JSlamConfig(camera=JCameraConfig(**CAM, **extra),
                       orb=JORBConfig(n_features=N_FEATURES),
                       sensor=JSensor.RGBD if rgbd else JSensor.MONOCULAR,
                       th_depth=2.05, depth_map_factor=1.0)
    pcfg = SlamConfig(camera=CameraConfig(**CAM, **extra),
                      orb=ORBConfig(n_features=N_FEATURES),
                      sensor=Sensor.RGBD if rgbd else Sensor.MONOCULAR,
                      th_depth=2.05, depth_map_factor=1.0)
    fb = JFrameBuilder(jcfg)
    built = [fb.build_rgbd(f, d, i / 30.0) if rgbd else fb.build(f, i / 30.0)
             for i, (f, d) in enumerate(zip(frames[:2], depths[:2]))]
    packed = [np.asarray(b.packed_dev) for b in built]
    assert packed[0].shape[1] == (18 if rgbd else 16)
    feats0 = JFrameBuilder._unpack_feats(packed[0])
    lm, mp_ids = seed_map_from_depth(feats0, poses[0].astype(np.float32),
                                     depths[0], cam, fb.scale_factors,
                                     LOCAL_SLOTS)
    T_prev, T_last, assoc, remap = _chain_inputs(
        np.random.default_rng(3), cam, lm, mp_ids, poses)
    block = (lm.pos, lm.normal, lm.mind, lm.maxd, lm.desc, lm.valid)
    n = fb.extractor.n_slots

    jprog = JTrackPrograms(jcfg, n, LOCAL_SLOTS, fb.bounds)
    jT_last, jT_cur, jassoc, jout = jprog.chain_step(
        jnp.asarray(T_prev), jnp.asarray(T_last),
        jnp.asarray(assoc.astype(np.int32)), remap.astype(np.int32),
        jnp.asarray(packed[0]), jnp.asarray(packed[1]),
        tuple(jnp.asarray(a) for a in block))
    jdec = jprog.decode_chain_out(np.asarray(jout))

    pprog = TrackPrograms(pcfg, n, LOCAL_SLOTS, fb.bounds, "cpu")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (t(T_prev), t(T_last), t(assoc), t(remap),
            packed_frame_from_numpy(packed[0], "cpu"),
            packed_frame_from_numpy(packed[1], "cpu"),
            local_block_from_numpy(*block, "cpu"))
    with no_host_reads():
        pT_last, pT_cur, passoc, pout = pprog.chain_step(*args)
    assert pout.shape == (pprog.chain_out_size,)
    pdec = pprog.decode_chain_out(pout.numpy())

    (jT2, ja, jv, jal, *jcounts), (pT2, pa, pv, pal, *pcounts) = jdec, pdec
    assert jcounts[1] >= 100 and jcounts[3] >= 100, jcounts   # a real step
    np.testing.assert_allclose(pT2, jT2, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pT_last.numpy(), np.asarray(jT_last), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(pT_cur.numpy(), pT2)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(passoc.numpy(), np.asarray(jassoc))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pal, jal)
    assert pcounts == jcounts
    if rgbd:
        n_close = pcounts[-1]
        assert n_close[0] > 0 and n_close[1] > 0, n_close


def test_se3_project_np_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        T = np.eye(4)
        T[:3, :3] = R + rng.normal(scale=0.05, size=(3, 3))
        T[:3, 3] = rng.normal(size=3)
        got = lie.se3_project_np(T)
        np.testing.assert_allclose(got, jlie.se3_project_np(T), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got[:3, :3] @ got[:3, :3].T, np.eye(3),
                                   atol=1e-12)
        assert np.linalg.det(got[:3, :3]) > 0


@pytest.fixture(scope="module")
def port_pipelined(tmp_path_factory):
    """The port's sync pipelined run, its chain_enqueue under the guard."""
    from orb_slam_system_tpu_torch.models import tracking

    original = tracking.Tracker.chain_enqueue
    calls = []

    def guarded(self, *a, **kw):
        calls.append(1)
        with no_host_reads():
            return original(self, *a, **kw)

    tracking.Tracker.chain_enqueue = guarded
    try:
        slam, rmse = run(N_FRAMES, str(tmp_path_factory.mktemp("pipe")),
                         N_FEATURES, device="cpu", verbose=False,
                         pipelined=True)
    finally:
        tracking.Tracker.chain_enqueue = original
    return slam, rmse, len(calls)


@pytest.fixture(scope="module")
def jax_pipelined():
    pcfg = make_config(W, H, N_FEATURES)
    frames, poses = render_sequence(pcfg, N_FRAMES)
    cfg = JSlamConfig(camera=JCameraConfig(**CAM),
                      orb=JORBConfig(n_features=N_FEATURES))
    slam = JSystem(None, cfg)
    states = [int(slam.get_tracking_state()) for _ in
              slam.track_monocular_pipelined(
                  (img, i / 30.0) for i, img in enumerate(frames))]
    slam.shutdown()
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}
    est = jtraj.frame_poses(slam.arena, slam.tracker.trajectory)
    return slam, jtraj.ate_rmse(est, gt), states


def test_pipelined_system_matches_jax(port_pipelined, jax_pipelined):
    slam, rmse, n_enqueued = port_pipelined
    jslam, jrmse, jstates = jax_pipelined
    recs = slam.telemetry.records
    # One record and one trajectory entry per frame, in order.
    assert [r["t"] for r in recs] == [i / 30.0 for i in range(N_FRAMES)]
    assert [e.timestamp for e in slam.tracker.trajectory] == \
        [i / 30.0 for i in range(1, N_FRAMES)]
    assert [r["state"] for r in recs] == jstates
    assert jstates.count(int(TrackingState.OK)) >= N_FRAMES - 2
    assert slam.arena.n_keyframes() == jslam.arena.n_keyframes()
    accepts = slam.tracker.chain_stats["accept"]
    assert accepts >= 10 and n_enqueued >= accepts
    assert abs(accepts - jslam.tracker.chain_stats["accept"]) <= 2
    assert rmse < 0.03 and jrmse < 0.03
    assert abs(rmse - jrmse) < 0.005, (rmse, jrmse)
    assert slam.tracker.epoch_violations == 0
