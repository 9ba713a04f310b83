"""Rotated BRIEF (rBRIEF) 256-bit descriptors and kernel C.

Port of orb_slam_system_tpu/ops/brief.py (reference computeOrbDescriptor
with the standard ORB pattern). Each keypoint's angle is quantized to one of
32 bins; bit b compares the bf16-rounded blurred patch at the bin-rotated
test points: bit = bf16(I[p2]) > bf16(I[p1]). Bits pack little-endian into
8 words (bit i of word w = test w*32 + i), so the words viewed as bytes are
OpenCV descriptor rows.

Descriptors are int32 in the port (the same 32-bit patterns as the JAX
package's uint32): torch.uint32 supports too few ops. Shifts of words go
through int64 with a mask so negative words never sign-extend.

Kernel C (`brief_pack`, csrc/brief_pack.cu) computes the bits by direct
compare and packs them with a warp ballot; `brief_pack_plain` is its plain
PyTorch version, used for CPU tensors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from orb_slam_system_tpu_torch.ops.brief_pattern import ORB_PATTERN
from orb_slam_system_tpu_torch.utils import kernels

N_BITS = 256
PATCH_RADIUS = 18     # max rotated |offset| = round(hypot(13, 13)) = 18
N_ANGLE_BINS = 32


@functools.lru_cache(maxsize=1)
def offset_table() -> np.ndarray:
    """int8[32, 256, 4]: per angle bin and test, (x1, y1, x2, y2) in
    blurred-patch coordinates (0..36), rotated with exactly the rotation
    and Python rounding of the JAX package's _binned_test_matrices."""
    P = 2 * PATCH_RADIUS + 1
    tab = np.zeros((N_ANGLE_BINS, N_BITS, 4), np.int8)
    pat = ORB_PATTERN.astype(np.float64)
    for a in range(N_ANGLE_BINS):
        th = 2 * np.pi * a / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        for b in range(N_BITS):
            x1, y1, x2, y2 = pat[b]
            row = (int(round(x1 * ca - y1 * sa)) + PATCH_RADIUS,
                   int(round(x1 * sa + y1 * ca)) + PATCH_RADIUS,
                   int(round(x2 * ca - y2 * sa)) + PATCH_RADIUS,
                   int(round(x2 * sa + y2 * ca)) + PATCH_RADIUS)
            assert 0 <= min(row) and max(row) < P
            tab[a, b] = row
    return tab


@functools.lru_cache(maxsize=None)
def _table_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(offset_table()).to(device)


def _angle_bins(angles: torch.Tensor) -> torch.Tensor:
    bin_f = angles * (N_ANGLE_BINS / (2 * math.pi))
    return torch.round(bin_f).to(torch.int64) % N_ANGLE_BINS


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits: bool/int[..., 256] of 0/1 -> packed int32[..., 8], bit i of word
    w = test w*32 + i."""
    *lead, nb = bits.shape
    assert nb == N_BITS
    grouped = bits.to(torch.int64).reshape(*lead, 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (grouped << shifts).sum(dim=-1)               # 0 .. 2^32 - 1
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """packed int32[..., 8] -> bits int64[..., 256] of 0/1."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    words = desc.to(torch.int64) & 0xFFFFFFFF
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], N_BITS)


def brief_pack_plain(blurred: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C. blurred: f32[B,N,37,37] (the blurred
    patch, keypoint at the centre); angles: f32[B,N] radians. Returns
    int32[B,N,8] packed descriptors."""
    B, N, P, _ = blurred.shape
    assert P == 2 * PATCH_RADIUS + 1
    tab = _table_on(blurred.device).to(torch.int64)[_angle_bins(angles)]
    i1 = (tab[..., 1] * P + tab[..., 0]).reshape(B, N * N_BITS)
    i2 = (tab[..., 3] * P + tab[..., 2]).reshape(B, N * N_BITS)
    # Offset of each keypoint's patch in the flattened [N*P*P] row.
    rows = (torch.arange(N, device=blurred.device) * (P * P)).repeat_interleave(N_BITS)
    src = blurred.reshape(B, N * P * P).to(torch.bfloat16)
    v1 = torch.gather(src, 1, i1 + rows)
    v2 = torch.gather(src, 1, i2 + rows)
    return pack_bits((v2 > v1).reshape(B, N, N_BITS))


def brief_pack(blurred: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Kernel C on CUDA tensors, the plain version on CPU tensors."""
    if blurred.is_cpu:
        return brief_pack_plain(blurred, angles)
    kernels.check_cuda(blurred, "brief_pack blurred", torch.float32, 4)
    kernels.check_cuda(angles, "brief_pack angles", torch.float32, 2)
    B, N, P, P2 = blurred.shape
    if P != 2 * PATCH_RADIUS + 1 or P2 != P or tuple(angles.shape) != (B, N):
        raise ValueError(f"brief_pack shapes {tuple(blurred.shape)}, "
                         f"{tuple(angles.shape)}")
    desc = torch.empty((B, N, 8), dtype=torch.int32, device=blurred.device)
    kernels.launch("orb_brief_pack", "brief_pack", blurred.data_ptr(),
                   angles.data_ptr(), _table_on(blurred.device).data_ptr(),
                   desc.data_ptr(), B * N)
    return desc
