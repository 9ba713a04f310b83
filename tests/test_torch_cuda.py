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
