"""Kernel B's describe mode, `gather_blur_describe`, on the CPU (where it
runs its plain version) against the JAX package's oracle chain on the same
numpy canvas and centres: gather_patches -> extractor._blur_patches ->
moments with moment_weights -> angles_from_moments ->
brief.compute_descriptors_dense.

Tolerances: moments atol 0.5 (those of tests/test_gather_pallas.py);
keypoints whose angle bin differs are counted apart (at most 1 in 64);
descriptor bits are equal on every other keypoint.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.ops import brief as jbrief
from orb_slam_system_tpu.ops.extractor import _blur_patches as j_blur
from orb_slam_system_tpu.ops.orientation import HALF_PATCH
from orb_slam_system_tpu.ops.orientation import angles_from_moments as j_angles
from orb_slam_system_tpu.ops.orientation import moment_weights as j_weights
from orb_slam_system_tpu.ops.patches import gather_patches as j_gather
from orb_slam_system_tpu_torch.ops import patches
from orb_slam_system_tpu_torch.ops.brief import _angle_bins
from orb_slam_system_tpu_torch.ops.orientation import _umax_table, moment_weights


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KERNEL_B = (Path(__file__).resolve().parent.parent / "orb_slam_system_tpu_torch"
            / "csrc" / "gather_blur_moments.cu")


def _jax_chain(img, xy):
    """(moments, angle, desc as uint32) from the JAX package's functions."""
    p = j_gather(jnp.asarray(img), jnp.asarray(xy), 21)
    c0, po = 21 - HALF_PATCH, 2 * HALF_PATCH + 1
    sub = np.asarray(p)[:, :, c0:c0 + po, c0:c0 + po]
    wx, wy = j_weights()
    mom = np.stack([(sub * wx).sum(axis=(2, 3)), (sub * wy).sum(axis=(2, 3))],
                   axis=-1)
    ang = j_angles(jnp.asarray(mom))
    desc = jbrief.compute_descriptors_dense(j_blur(p), ang)
    return mom, np.asarray(ang), np.asarray(desc)


@pytest.mark.parametrize("values", ["uniform", "integer"])
def test_gather_blur_describe_matches_jax_chain(values, rng):
    """96x160 canvas, B = 2, N = 32, with keypoints whose patch start is
    clipped at every edge."""
    B, H, W, N = 2, 96, 160, 32
    if values == "uniform":
        img = rng.uniform(0, 255, size=(B, H, W)).astype(np.float32)
    else:
        img = rng.integers(0, 256, size=(B, H, W)).astype(np.float32)
    xy = np.stack([rng.integers(-10, W + 10, size=(B, N)),
                   rng.integers(-10, H + 10, size=(B, N))],
                  axis=-1).astype(np.int32)
    xy[0, :4] = [[0, 0], [W - 1, H - 1], [-3, H + 2], [W + 5, 1]]
    xy[1, :2] = [[21, 21], [W - 22, H - 22]]
    want_mom, want_ang, want_desc = _jax_chain(img, xy)
    mom, ang, desc = patches.gather_blur_describe(torch.from_numpy(img),
                                                  torch.from_numpy(xy))
    assert mom.shape == (B, N, 2) and ang.shape == (B, N)
    assert desc.shape == (B, N, 8) and desc.dtype == torch.int32
    np.testing.assert_allclose(mom.numpy(), want_mom, rtol=0, atol=0.5)
    flips = (_angle_bins(ang).numpy()
             != np.asarray(jbrief._angle_bins(jnp.asarray(want_ang))))
    assert flips.sum() <= 1, f"{flips.sum()} angle-bin flips"
    differ = (desc.numpy().view(np.uint32) != want_desc).any(-1)
    assert not (differ & ~flips).any()


def test_gather_blur_describe_no_keypoints():
    """N = 0 at B = 2: empty outputs of the right shapes and types, from
    both modes of kernel B's plain path."""
    canvas = torch.zeros((2, 64, 64))
    xy = torch.zeros((2, 0, 2), dtype=torch.int32)
    mom, ang, desc = patches.gather_blur_describe(canvas, xy)
    assert mom.shape == (2, 0, 2) and ang.shape == (2, 0)
    assert desc.shape == (2, 0, 8) and desc.dtype == torch.int32
    blurred, mom_b = patches.gather_blur_moments(canvas, xy)
    assert blurred.shape == (2, 0, 37, 37) and mom_b.shape == (2, 0, 2)


def test_kernel_b_circle_constant():
    """Kernel B's moments take the circle per column, |dy| <= umax[|dx|],
    from a 64-bit constant: it must hold orientation._umax_table, and the
    circle must be symmetric for the per-column rows to be the mask of
    moment_weights."""
    m = re.search(r"kUmax = 0x([0-9a-f]+)ull", KERNEL_B.read_text())
    assert m, "kUmax not found in the kernel source"
    packed = int(m.group(1), 16)
    umax = _umax_table()
    assert [(packed >> (4 * i)) & 0xF for i in range(16)] == list(umax)
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    by_row = np.abs(d)[None, :] <= umax[np.abs(d)][:, None]     # [dy, dx]
    by_col = np.abs(d)[:, None] <= umax[np.abs(d)][None, :]
    np.testing.assert_array_equal(by_row, by_col)
    wx, wy = moment_weights()
    np.testing.assert_array_equal(wx, np.where(by_col, d[None, :], 0))
    np.testing.assert_array_equal(wy, np.where(by_col, d[:, None], 0))
