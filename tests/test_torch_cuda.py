"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: they skip without a GPU (a CUDA kernel has no CPU mode).
Run them on a machine with an NVIDIA GPU and nvcc (--noconftest: the
shared conftest imports jax, which that machine need not have):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from orb_slam_system_tpu_torch.ops import brief, fast, patches
from orb_slam_system_tpu_torch.ops.orientation import angles_from_moments

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("h,w", [(480, 640), (161, 214), (64, 70)])
def test_fast_score_nms_bit_exact(dev, h, w, rng):
    img = torch.from_numpy(rng.integers(0, 256, (2, h, w)).astype(np.float32)).to(dev)
    got = fast.fast_score_nms(img, 19)
    want = fast.nms3x3(fast.fast_score_map(img, 19))
    assert torch.equal(got, want)


def test_gather_blur_moments(dev, rng):
    canvas = torch.from_numpy(rng.uniform(0, 255, (2, 300, 200)).astype(np.float32)).to(dev)
    xy = torch.from_numpy(np.stack([rng.integers(-5, 210, (2, 300)),
                                    rng.integers(-5, 310, (2, 300))],
                                   -1).astype(np.int32)).to(dev)
    kb, km = patches.gather_blur_moments(canvas, xy, 21)
    pb, pm = patches.gather_blur_moments_plain(canvas, xy, 21)
    assert torch.equal(kb, pb)
    assert float((km - pm).abs().max()) <= 0.5


def test_brief_pack_bit_exact(dev, rng):
    blurred = torch.from_numpy(rng.uniform(0, 255, (1, 777, 37, 37)).astype(np.float32)).to(dev)
    ang = angles_from_moments(torch.from_numpy(
        rng.normal(size=(1, 777, 2)).astype(np.float32)).to(dev))
    assert torch.equal(brief.brief_pack(blurred, ang),
                       brief.brief_pack_plain(blurred, ang))


def test_wrappers_check_arguments(dev):
    with pytest.raises(TypeError):
        fast.fast_score_nms(torch.zeros((1, 64, 64), dtype=torch.float64,
                                        device=dev), 19)
    with pytest.raises(ValueError):
        fast.fast_score_nms(torch.zeros((1, 64, 128), device=dev)[:, :, ::2], 19)


@pytest.mark.parametrize("radius", [21, 5])
def test_gather_patches_bit_exact(dev, rng, radius):
    """Kernel D against its plain version, including clipped edge
    keypoints, at the extractor's radius and one other."""
    canvas = torch.from_numpy(rng.uniform(0, 255, (2, 300, 200)).astype(np.float32)).to(dev)
    xy = torch.from_numpy(np.stack([rng.integers(-5, 210, (2, 2048)),
                                    rng.integers(-5, 310, (2, 2048))],
                                   -1).astype(np.int32)).to(dev)
    assert torch.equal(patches.gather_patches(canvas, xy, radius),
                       patches.gather_patches_plain(canvas, xy, radius))


def test_unfused_route_matches_fused_route(dev):
    """The extractor's unfused route (kernel D + plain moments and blur)
    against the fused route (kernel B) on the card: identical keypoints,
    descriptor bits equal except at counted angle-bin flips (<= 1%)."""
    from orb_slam_system_tpu_torch.config import ORBConfig
    from orb_slam_system_tpu_torch.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu_torch.ops.brief import _angle_bins
    from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor

    K = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]])
    r = PlanarSceneRenderer(K, 640, 480, texture=make_texture(2048, 8, 7),
                            tex_scale=440.0)
    img = torch.from_numpy(r.render(orbit_trajectory(2, 0.35, -2.0, 0.3)[1])
                           .astype(np.float32)).to(dev)[None]
    cfg = ORBConfig(n_features=2000)
    fu = ORBExtractor(cfg, 480, 640, fused_gather=True)(img)
    un = ORBExtractor(cfg, 480, 640, fused_gather=False)(img)
    assert torch.equal(fu.xy, un.xy) and torch.equal(fu.valid, un.valid)
    flips = (_angle_bins(fu.angle) != _angle_bins(un.angle)) & fu.valid
    assert int(flips.sum()) <= 0.01 * int(fu.valid.sum())
    diff = (fu.desc != un.desc).any(-1) & fu.valid
    assert not bool((diff & ~flips).any())
