"""256-bit Hamming distances.

Port of orb_slam_system_tpu/ops/hamming.py (reference
ORBmatcher::DescriptorDistance). `distance_matrix` unpacks descriptors to
+-1 vectors; for 256-bit strings dot(a, b) = 256 - 2*hamming. The +-1
operands and every partial sum (|sum| <= 256) are exact in f32 and in
TF32, so the f32 matmul gives exact integer distances on the CPU and on
the card.
"""

from __future__ import annotations

import torch

from orb_slam_system_tpu_torch.ops.brief import unpack_bits

N_BITS = 256


def to_pm1(desc: torch.Tensor) -> torch.Tensor:
    """packed int32[..., 8] -> f32[..., 256] in {-1, +1}."""
    return (2 * unpack_bits(desc) - 1).to(torch.float32)


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances: int32[N1, 8] x int32[N2, 8] ->
    int32[N1, N2]."""
    dot = to_pm1(desc_a) @ to_pm1(desc_b).T
    return ((N_BITS - dot) * 0.5).round().to(torch.int32)


_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words held in int64 (0 .. 2^32-1)."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def distance_pairwise(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance: int32[..., 8] x int32[..., 8] ->
    int32[...]."""
    x = torch.bitwise_xor(desc_a, desc_b).to(torch.int64) & 0xFFFFFFFF
    return popcount32(x).sum(dim=-1).to(torch.int32)
