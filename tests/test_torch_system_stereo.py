"""The port's stereo System end to end on the CPU, against the bars of
tests/test_e2e_stereo.py and against the JAX System on the same pairs.

Both run once, in module fixtures: the port through
drivers/stereo_synthetic.run, the JAX package through its
examples/stereo_synthetic.run, at that test's settings (320x240, fx 260,
0.12 m baseline, 400 features, 18 frames of the textured-plane orbit).
Criteria: the e2e file's checks on the port; the same initialization frame,
keyframe count and frames tracked as the JAX System, and an SE3-aligned
ATE within max(0.5 cm, 25%) of its ATE. The port's median-SAD filter drops
the matches the JAX package's keeps (tests/test_torch_stereo.py), so the
two maps differ by those points.

Last, a keyframe is forced on the port's finished run, so local BA runs
over two keyframes: its edges carry each keyframe's u_right.
"""

import os
import sys

import numpy as np
import pytest
import torch

from orb_slam_system_tpu_torch.config import TrackingState
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.drivers.stereo_synthetic import run


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_FRAMES, N_FEATURES = 18, 400


def _tracked(arena, trajectory, traj):
    return sum(1 for *_, lost in traj.frame_poses(arena, trajectory) if not lost)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_stereo")
    return run(n_frames=N_FRAMES, out_dir=str(out), n_features=N_FEATURES,
               device="cpu", verbose=False)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    from examples.stereo_synthetic import run as jrun
    from orb_slam_system_tpu.dataio import trajectory as jtraj

    out = tmp_path_factory.mktemp("jax_stereo")
    slam, rmse, _, _ = jrun(n_frames=N_FRAMES, out_dir=str(out), verbose=False,
                            n_features=N_FEATURES)
    kf0 = slam.arena.kfs[slam.arena.kf_origin_id]
    return dict(rmse=rmse, init_frame=kf0.frame_id,
                kfs=slam.arena.n_keyframes(),
                tracked=_tracked(slam.arena, slam.tracker.trajectory, jtraj))


def test_stereo_initializes_first_frame(port_run):
    slam, *_ = port_run
    kf0 = slam.arena.kfs.get(slam.arena.kf_origin_id)
    assert kf0 is not None and kf0.frame_id == 0
    assert slam.get_tracking_state() == TrackingState.OK


def test_stereo_metric_scale(port_run):
    _, rmse, span, span_gt = port_run
    assert rmse < 0.12
    assert abs(span - span_gt) / max(span_gt, 1e-9) < 0.15


def test_stereo_features_have_disparity(port_run):
    slam, *_ = port_run
    kf0 = slam.arena.kfs[slam.arena.kf_origin_id]
    ur = kf0.feats.u_right
    assert ur is not None
    matched = ur >= 0
    assert matched.sum() > 150
    disp = kf0.feats.xy_und[matched, 0] - ur[matched]
    assert (disp > 0).all()
    assert disp.max() < slam.cfg.camera.fx


def test_localization_mode_and_getters(port_run):
    slam, *_ = port_run
    assert len(slam.get_tracked_map_points()) > 30
    kps = slam.get_tracked_keypoints_un()
    assert kps.shape[1] == 2 and len(kps) > 100
    slam.activate_localization_mode()
    assert slam.tracker.only_tracking
    slam.deactivate_localization_mode()
    assert not slam.tracker.only_tracking


def test_matches_jax_system(port_run, jax_run):
    slam, rmse, _, _ = port_run
    kf0 = slam.arena.kfs[slam.arena.kf_origin_id]
    assert kf0.frame_id == jax_run["init_frame"]
    assert slam.arena.n_keyframes() == jax_run["kfs"]
    assert _tracked(slam.arena, slam.tracker.trajectory, traj_io) == jax_run["tracked"]
    assert abs(rmse - jax_run["rmse"]) <= max(0.005, 0.25 * jax_run["rmse"])


def test_keyframe_seeds_depth_points_and_local_ba_takes_stereo_edges(port_run):
    """Runs last: it adds a keyframe to the module's System. The forced
    keyframe seeds points from its close depths, the mapper processes it,
    and the local BA window over both keyframes carries each edge's u_right
    (-1 only where the keyframe's feature has no right match)."""
    slam, *_ = port_run
    n_points = slam.arena.n_points()
    slam.tracker.create_new_keyframe()
    kf = slam.arena.kfs[slam.tracker.last_kf_id]
    assert slam.arena.n_points() > n_points
    slam.local_mapper.process_pending()
    prob, _, _, _, edge_refs = slam.local_mapper._local_ba_prep(kf)
    e_ur = prob.e_ur.numpy()
    want = np.array([slam.arena.kfs[k].feats.u_right[slam.arena.mps[m].obs[k]]
                     for m, k in edge_refs], np.float32)
    np.testing.assert_array_equal(e_ur, want)
    assert (e_ur >= 0).mean() > 0.5
    assert {k for _, k in edge_refs} >= {kf.id, slam.arena.kf_origin_id}
