"""The port's KITTI-scale drive (drivers/kitti_synthetic.py) on a short
stretch, on the CPU, against the JAX package's examples/kitti_synthetic.py.

12 frames of the circuit at the full drive's ~5.1 cm a frame (laps =
2 * 12 / 4000) through the pipelined mode: the summary has the JAX
example's keys (it runs 2 frames for them, on a smaller texture: the keys
do not depend on it), >= n - 2 frames are tracked, and the export is the
reference artifact's: n-2..n KITTI rows (one per frame from
initialization on) of 12 floats with an orthonormal rotation, plus the
keyframe trajectory and summary.json.
"""

import numpy as np
import pytest
import torch

from examples import kitti_synthetic as jkitti
from orb_slam_system_tpu_torch.drivers import kitti_synthetic
from test_torch_long_run import small_jax_texture  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHORT = 12


def test_kitti_short_run(tmp_path, small_jax_texture):
    out = tmp_path / "kitti"
    slam, s = kitti_synthetic.run(SHORT, str(out), verbose=False,
                                  laps=2 * SHORT / 4000, device="cpu")
    _, js = jkitti.run(2, None, verbose=False, laps=2 * 2 / 4000)
    assert list(s) == list(js)
    assert s["n_frames"] == SHORT and s["n_tracked"] >= SHORT - 2
    rows = [ln.split() for ln in
            (out / "CameraTrajectory.txt").read_text().splitlines()]
    assert SHORT - 2 <= len(rows) <= SHORT
    assert all(len(r) == 12 for r in rows)
    M = np.asarray([float(v) for v in rows[len(rows) // 2]]).reshape(3, 4)
    np.testing.assert_allclose(M[:, :3] @ M[:, :3].T, np.eye(3), atol=1e-4)
    assert (out / "KeyFrameTrajectory.txt").read_text().strip()
    assert (out / "summary.json").exists()
