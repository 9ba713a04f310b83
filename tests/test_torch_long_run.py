"""The long-run drivers of the port (drivers/endurance_synthetic.py and
drivers/kitti_synthetic.py) and its global BA past GBA_DENSE_MAX_CAMS, on
the CPU, against the JAX package's examples/endurance_synthetic.py,
examples/kitti_synthetic.py and GBARunner.

* The clover and the drive circuit equal the JAX examples' poses within
  1e-12, over a few (frames, leaves / laps) cases.
* The clover's frames around the first degraded ones (frames 22-28 of a
  100-frame, one-leaf run) equal the JAX example's bit for bit: same
  renderer, blur and default_rng(1) noise in render order. The JAX frames
  are taken from its run() through a stand-in System that keeps what
  track_monocular is given.
* A short run of the endurance driver at the JAX per-frame motion (the
  first 12 poses of the 1250-frame clover): its summary has the JAX
  summary's keys (the JAX example runs 3 frames for them, on a smaller
  texture). The KITTI driver's short run is in
  tests/test_torch_long_run_kitti.py.
* GBARunner._solve on a map of 52 keyframes takes bundle_adjust_cg in both
  packages, and on one of 48 the dense Schur solve in both; the two
  packages' results agree within 1e-4 (tests/test_torch_lie_sim3.py's
  tolerance for bundle_adjust_cg).
"""

import numpy as np
import pytest
import torch

from examples import endurance_synthetic as jendurance
from examples import kitti_synthetic as jkitti
from orb_slam_system_tpu.config import CameraConfig as JCameraConfig
from orb_slam_system_tpu.models import loop_closing as jloop_closing
from orb_slam_system_tpu.solvers import local_ba as jlocal_ba
from orb_slam_system_tpu_torch.config import CameraConfig
from orb_slam_system_tpu_torch.drivers import endurance_synthetic, kitti_synthetic
from orb_slam_system_tpu_torch.drivers.mono_synthetic import make_config
from orb_slam_system_tpu_torch.models import loop_closing
from orb_slam_system_tpu_torch.solvers import local_ba
from orb_slam_system_tpu_torch.utils.interop import ba_problem_from_numpy
from orb_slam_system_tpu_torch.utils.metrics import StageTimer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHORT = 12                       # frames of each short driver run
ENV_KNOBS = ("ORB_SLAM_LOOP_DEBUG", "ORB_SLAM_CHAIN_CLASSIC_KF",
             "ORB_SLAM_KF_ASYNC_QUEUE", "ORB_SLAM_KF_ASYNC_WAIT",
             "ORB_SLAM_KF_SYNC_FLUSH", "ORB_SLAM_KF_DRAIN_RELEASE")


@pytest.mark.parametrize("kind,n,k", [
    ("drive", 4000, 2.0), ("drive", 2000, 1.0), ("drive", 24, 0.012),
    ("clover", 1250, 5), ("clover", 500, 2), ("clover", 24, 1)])
def test_trajectories_match_jax(kind, n, k):
    if kind == "drive":
        got = kitti_synthetic.drive_trajectory(n, laps=k)
        want = jkitti.drive_trajectory(n, laps=k)
    else:
        got = endurance_synthetic.clover_trajectory(n, leaves=k)
        want = jendurance.clover_trajectory(n, leaves=k)
    assert len(got) == len(want) == n
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=1e-12)


class _Enough(Exception):
    pass


def test_degraded_frames_match_jax(monkeypatch):
    """Frames 22-28 of a 100-frame, one-leaf clover: 22-24 clean, 25-28 the
    first degraded ones (from a quarter of the circle on)."""
    import orb_slam_system_tpu.models.system as jsystem

    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)
    n, lo, hi = 100, 22, 29
    seen = []

    class Recorder:
        """Keeps the frames; answers the run's per-frame bookkeeping."""

        def __init__(self, *a, **kw):
            self.arena = type("Arena", (), {"n_keyframes": lambda _: 0,
                                            "n_points": lambda _: 0})()
            self.loop_closer = type("Closer", (), {"n_loops_closed": 0})()

        def track_monocular(self, img, ts):
            seen.append(np.array(img, copy=True))
            if len(seen) == hi:
                raise _Enough

    monkeypatch.setattr(jsystem, "System", Recorder)
    with pytest.raises(_Enough):
        jendurance.run(n, verbose=False, leaves=1)
    got = []
    for i, _, img in endurance_synthetic.degraded_frames(
            make_config(n_features=400), n, 1):
        if i >= lo:
            got.append(img)
        if i + 1 == hi:
            break
    assert [i for i in range(lo, hi) if i / n >= 0.25] == [25, 26, 27, 28]
    for i, (a, b) in enumerate(zip(got, seen[lo:]), start=lo):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert np.array_equal(a, b), f"frame {i} differs"


@pytest.fixture
def small_jax_texture(monkeypatch):
    """The JAX examples' key runs draw a 1024-pixel texture (their summary's
    keys do not depend on it; the 4096- and 8192-pixel ones take seconds
    to make)."""
    import orb_slam_system_tpu.dataio.synthetic as jsynthetic

    make = jsynthetic.make_texture
    monkeypatch.setattr(jsynthetic, "make_texture",
                        lambda size=1024, block=8, seed=7: make(1024, block,
                                                                seed))


@pytest.fixture
def clover_start(monkeypatch):
    """Both packages' clover_trajectory give the first poses of the
    1250-frame, 5-leaf clover (its ~4.5 cm a frame), whatever they are
    asked for."""
    full = endurance_synthetic.clover_trajectory(1250, leaves=5)

    def first(n, leaves=4, **kw):
        return full[:n]
    monkeypatch.setattr(endurance_synthetic, "clover_trajectory", first)
    monkeypatch.setattr(jendurance, "clover_trajectory", first)
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


def test_endurance_short_run(clover_start, small_jax_texture):
    slam, s = endurance_synthetic.run(SHORT, verbose=False, leaves=1,
                                      device="cpu")
    _, js = jendurance.run(3, verbose=False, leaves=1)
    assert list(s) == list(js)
    assert s["n_frames"] == SHORT and s["n_tracked"] >= SHORT - 2
    assert s["n_keyframes_peak"] >= s["n_keyframes_final"] >= 3
    assert len(s["host_ms_median_thirds"]) == 3
    assert s["ate_rmse_m"] < 0.03


FX = FY = 300.0
CX, CY = 160.0, 120.0


def gba_snapshot(rng, n_cams, n_pts=240):
    """A map of n_cams keyframes 0.1 m apart along x over a strip of points
    no farther along x than the first and last keyframe (so each point is
    seen by at least 15 keyframes), each keyframe seeing the points within
    1.5 m of it across, with noisy
    observations, perturbed poses (keyframe 0 fixed) and points: numpy
    (Tcw, points, e_cam, e_pt, e_uv, e_inv_sigma2)."""
    span = 0.1 * (n_cams - 1)
    X = np.stack([rng.uniform(0.0, span, n_pts),
                  rng.uniform(-1.0, 1.0, n_pts),
                  rng.uniform(4.0, 7.0, n_pts)], 1).astype(np.float32)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    Tcw[:, 0, 3] = -0.1 * np.arange(n_cams)
    e_cam, e_pt, e_uv = [], [], []
    for c in range(n_cams):
        Xc = X @ Tcw[c, :3, :3].T + Tcw[c, :3, 3]
        seen = np.nonzero(np.abs(X[:, 0] - 0.1 * c) < 1.5)[0]
        uv = Xc[seen, :2] / Xc[seen, 2:3] * [FX, FY] + [CX, CY]
        e_cam += [c] * len(seen)
        e_pt += list(seen)
        e_uv.append(uv + rng.normal(size=uv.shape) * 0.5)
    Tcw0 = Tcw.copy()
    Tcw0[1:, :3, 3] += rng.normal(scale=0.01, size=(n_cams - 1, 3))
    X0 = X + rng.normal(scale=0.03, size=X.shape).astype(np.float32)
    E = len(e_cam)
    return (Tcw0.astype(np.float32), X0.astype(np.float32),
            np.asarray(e_cam, np.int32), np.asarray(e_pt, np.int32),
            np.concatenate(e_uv).astype(np.float32),
            rng.uniform(0.5, 1.0, E).astype(np.float32))


def _spy(monkeypatch, module, log):
    for name in ("bundle_adjust", "bundle_adjust_cg"):
        orig = getattr(module, name)

        def call(*a, _orig=orig, _name=name, **kw):
            log.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(module, name, call)


@pytest.mark.parametrize("n_cams,solver", [(52, "bundle_adjust_cg"),
                                           (48, "bundle_adjust")])
def test_gba_runner_matches_jax_across_cutover(rng, monkeypatch, n_cams,
                                               solver):
    import jax.numpy as jnp

    Tcw, X, e_cam, e_pt, e_uv, e_is2 = gba_snapshot(rng, n_cams)
    C, P, E = n_cams, len(X), len(e_cam)
    jprob = jlocal_ba.BAProblem(
        Tcw=jnp.asarray(Tcw), cam_fixed=jnp.asarray(np.arange(C) == 0),
        cam_valid=jnp.asarray(np.ones(C, bool)), points=jnp.asarray(X),
        pt_valid=jnp.asarray(np.ones(P, bool)), e_cam=jnp.asarray(e_cam),
        e_pt=jnp.asarray(e_pt), e_uv=jnp.asarray(e_uv),
        e_inv_sigma2=jnp.asarray(e_is2),
        e_valid=jnp.asarray(np.ones(E, bool)),
        e_ur=jnp.asarray(np.full(E, -1.0, np.float32)), bf=0.0)
    kf_ids, mp_ids = list(range(C)), list(range(P))
    old = {k: Tcw[k].copy() for k in kf_ids}
    jcam = JCameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, width=320, height=240)
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, width=320, height=240)

    jlog, log = [], []
    _spy(monkeypatch, jlocal_ba, jlog)
    _spy(monkeypatch, local_ba, log)
    jrunner = jloop_closing.GBARunner()
    jrunner._solve((jprob, kf_ids, mp_ids, old), jcam,
                   dense_max_cams=jloop_closing.GBA_DENSE_MAX_CAMS)
    _, _, _, jT, jX = jrunner.take_result()
    runner = loop_closing.GBARunner(StageTimer("loop"))
    runner._solve((ba_problem_from_numpy(jprob, "cpu"), kf_ids, mp_ids), cam)
    r_kf, r_mp, T, Xn = runner.take_result()

    n_chunks = loop_closing.GBARunner.N_CHUNKS
    assert loop_closing.GBA_DENSE_MAX_CAMS == jloop_closing.GBA_DENSE_MAX_CAMS
    assert jlog == [solver] * n_chunks and log == [solver] * n_chunks
    assert (r_kf, r_mp) == (kf_ids, mp_ids)
    np.testing.assert_allclose(T, np.asarray(jT), rtol=0, atol=1e-4)
    np.testing.assert_allclose(Xn, np.asarray(jX), rtol=0, atol=1e-4)
    # The solve moved the map (the perturbed start is not its answer).
    assert not np.allclose(T, Tcw, atol=1e-4)
