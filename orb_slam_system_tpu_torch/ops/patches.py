"""Batched square-patch gathering, the in-patch blur, and kernels B and D.

Port of orb_slam_system_tpu/ops/patches.py plus the extractor's patch blur
(`_blur_patches`) and the two Pallas gathers of gather_pallas.py:
  * kernel D (`gather_patches`, csrc/gather_patches.cu; TPU
    gather_patches_pallas) copies each keypoint's raw square patch; its
    plain version is `gather_patches_plain`;
  * kernel B (`gather_blur_moments`, csrc/gather_blur_moments.cu; TPU
    gather_blur_moments_pallas) gathers each keypoint's 43x43 patch from
    the all-level canvas, blurs it to 37x37 and reduces the IC moments in
    one pass; its plain version is `gather_blur_moments_plain`.
Each wrapper runs its plain version on a CPU tensor and its kernel on a
CUDA tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from orb_slam_system_tpu_torch.ops.orientation import (HALF_PATCH,
                                                        moment_weights,
                                                        patch_moments)
from orb_slam_system_tpu_torch.ops.pyramid import gaussian_kernel_1d
from orb_slam_system_tpu_torch.utils import kernels

BLUR_TAPS = 7


def gather_flat_index(xy: torch.Tensor, radius: int, H: int, W: int) -> torch.Tensor:
    """Flat pixel index i64[B, N*P*P] of every patch element: the patch
    start is clipped so the block stays inside the H x W image."""
    B = xy.shape[0]
    P = 2 * radius + 1
    x0 = (xy[..., 0].long() - radius).clamp(0, W - P)
    y0 = (xy[..., 1].long() - radius).clamp(0, H - P)
    off = torch.arange(P, device=xy.device)
    rows = (y0[..., None] + off)[..., :, None]            # [B,N,P,1]
    cols = (x0[..., None] + off)[..., None, :]            # [B,N,1,P]
    return (rows * W + cols).reshape(B, -1)


def gather_patches_plain(img: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of kernel D. img: f32[B,H,W]; xy: int[B,N,2] (x, y)
    integer centers -> patches f32[B,N,P,P], P = 2*radius+1. Patch starts
    are clipped so the block stays inside the image (a no-op for keypoints
    inside the border margin)."""
    B, H, W = img.shape
    P = 2 * radius + 1
    flat = gather_flat_index(xy, radius, H, W)
    return torch.gather(img.reshape(B, H * W), 1, flat).reshape(*xy.shape[:2], P, P)


def gather_patches(img: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """Kernel D on a CUDA image, the plain version on a CPU image. Same
    contract as gather_patches_plain; xy is i32[B,N,2] on the card."""
    if img.device.type == "cpu":
        return gather_patches_plain(img, xy, radius)
    kernels.check_cuda(img, "gather_patches img", torch.float32, 3)
    kernels.check_cuda(xy, "gather_patches xy", torch.int32, 3)
    B, H, W = img.shape
    if xy.shape[0] != B or xy.shape[2] != 2:
        raise ValueError(f"xy shape {tuple(xy.shape)} does not match image")
    P = 2 * radius + 1
    if radius < 0 or P > H or P > W:
        raise ValueError(f"radius {radius} does not fit a {H}x{W} image")
    N = xy.shape[1]
    out = torch.empty((B, N, P, P), device=img.device)
    kernels.launch("orb_gather_patches", "gather_patches", img.data_ptr(),
                   xy.data_ptr(), out.data_ptr(), B, N, H, W, radius)
    return out


def blur_patches(patches: torch.Tensor) -> torch.Tensor:
    """Valid-mode separable 7x7 sigma=2 Gaussian over [B,N,P,P] patches:
    rows first, then columns, each output summed in tap order with a
    separate rounding per product and per sum (the JAX package's
    extractor._blur_patches)."""
    k = [float(v) for v in gaussian_kernel_1d(BLUR_TAPS, 2.0)]
    x = patches
    n = x.shape[2] - (BLUR_TAPS - 1)
    out = x[:, :, 0:n] * k[0]
    for i in range(1, BLUR_TAPS):
        out = out + x[:, :, i:i + n] * k[i]
    x = out
    n = x.shape[3] - (BLUR_TAPS - 1)
    out = x[..., 0:n] * k[0]
    for i in range(1, BLUR_TAPS):
        out = out + x[..., i:i + n] * k[i]
    return out


def gather_blur_moments_plain(canvas: torch.Tensor, xy: torch.Tensor,
                              radius: int = 21):
    """Plain version of kernel B. canvas: f32[B,H,W] (reflect-padded by the
    caller); xy: int[B,N,2] centers. Returns (blurred f32[B,N,P-6,P-6],
    moments f32[B,N,2] = (m10, m01) of the unblurred circular 31x31 centre)."""
    patches = gather_patches_plain(canvas, xy, radius)
    c0 = radius - HALF_PATCH
    po = 2 * HALF_PATCH + 1
    mom = patch_moments(patches[:, :, c0:c0 + po, c0:c0 + po])
    return blur_patches(patches), mom


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """Kernel B's tables on `device`: blur taps f32[7] and the moment
    weights f32[2,31,31]."""
    wx, wy = moment_weights()
    taps = torch.from_numpy(gaussian_kernel_1d(BLUR_TAPS, 2.0)).to(device)
    return taps, torch.from_numpy(np.stack([wx, wy])).to(device)


def gather_blur_moments(canvas: torch.Tensor, xy: torch.Tensor,
                        radius: int = 21):
    """Kernel B on a CUDA canvas, the plain version on a CPU canvas. Same
    contract as gather_blur_moments_plain; xy is i32[B,N,2] on the card."""
    if canvas.device.type == "cpu":
        return gather_blur_moments_plain(canvas, xy, radius)
    kernels.check_cuda(canvas, "gather_blur_moments canvas", torch.float32, 3)
    kernels.check_cuda(xy, "gather_blur_moments xy", torch.int32, 3)
    B, H, W = canvas.shape
    if xy.shape[0] != B or xy.shape[2] != 2:
        raise ValueError(f"xy shape {tuple(xy.shape)} does not match canvas")
    if radius != 21:
        raise ValueError("kernel B is built for radius 21 (43x43 patches)")
    N = xy.shape[1]
    pb = 2 * radius + 1 - (BLUR_TAPS - 1)
    blurred = torch.empty((B, N, pb, pb), device=canvas.device)
    mom = torch.empty((B, N, 2), device=canvas.device)
    taps, wxy = _constants(canvas.device)
    kernels.launch("orb_gather_blur_moments", "gather_blur_moments",
                   canvas.data_ptr(), xy.data_ptr(), taps.data_ptr(),
                   wxy.data_ptr(), blurred.data_ptr(), mom.data_ptr(),
                   B, N, H, W, radius)
    return blurred, mom
