"""The port's KITTI-scale drive on the card (the counterpart of
tests/test_kitti_scale.py, with its bars). Env-gated:

    ORB_SLAM_RUN_KITTI_SCALE=1 python -m pytest tests/test_torch_kitti_scale.py \\
        -q -s -m cuda --noconftest

drivers/kitti_synthetic.run over ORB_SLAM_KITTI_FRAMES frames (4000 by
default) through the pipelined mode, ORB_SLAM_KITTI_ASYNC=1 for the async
mapper; the laps scale with the frames (2 at 4000), so a shorter run keeps
the full drive's ~5.1 cm a frame. Bars: >= 90% tracked, >= 1 loop, ATE <
30 cm, fewer than n / 4 keyframes at the end, the last third's host-ms
median within 3x the first's, and the KITTI export: n-2..n rows of 12
floats with an orthonormal rotation. Prints the summary with every
global-BA solve's keyframes and solvers and the saved map's bytes per
keyframe as one JSON line.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_endurance import gba_solves, report  # noqa: F401 (a fixture)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(os.environ.get("ORB_SLAM_RUN_KITTI_SCALE") != "1",
                       reason="drive-scale run (set ORB_SLAM_RUN_KITTI_SCALE=1)")]


def test_kitti_scale_drive(tmp_path, gba_solves):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from orb_slam_system_tpu_torch.drivers.kitti_synthetic import run

    n = int(os.environ.get("ORB_SLAM_KITTI_FRAMES", "4000"))
    out = str(tmp_path / "kitti")
    slam, s = run(n_frames=n, out_dir=out, verbose=True, laps=2.0 * n / 4000,
                  async_mapping=os.environ.get("ORB_SLAM_KITTI_ASYNC") == "1",
                  device="cuda")
    report(slam, s, gba_solves, tmp_path)
    assert s["n_tracked"] >= 0.9 * n, s
    assert s["loops_closed"] >= 1, s["loop_stats"]
    assert s["ate_rmse_m"] < 0.30, s
    assert s["n_keyframes_final"] < 0.25 * n, s
    m1, _, m3 = s["host_ms_median_thirds"]
    assert m3 < 3.0 * max(m1, 1.0), s["host_ms_median_thirds"]
    rows = [ln.split() for ln in open(
        os.path.join(out, "CameraTrajectory.txt")).read().splitlines()]
    assert n - 2 <= len(rows) <= n, len(rows)
    assert all(len(r) == 12 for r in rows)
    M = np.asarray([float(v) for v in rows[len(rows) // 2]]).reshape(3, 4)
    np.testing.assert_allclose(M[:, :3] @ M[:, :3].T, np.eye(3), atol=1e-4)
    assert slam.tracker.epoch_violations == 0
