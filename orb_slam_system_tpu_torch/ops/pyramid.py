"""Image pyramid (cascaded bilinear resize) and the 7-tap Gaussian.

Port of orb_slam_system_tpu/ops/pyramid.py (reference
ORBextractor::ComputePyramid, 8 levels, scale 1.2, each level resized from
the previous one).

The JAX package applies the resize as two dense matmuls with constant
[n_out, n_in] matrices (`_resize_matrix`, two nonzeros per row) because its
accelerator's matrix unit makes that cheap. Here the same two taps and
weights are applied directly: a gather and two products per output sample.
That computes the same sum with plain f32 products and one add, never
touches TF32, and rounds identically on the CPU and the card (a matmul's
FMA and blocking choices differ between BLAS builds).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def level_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static per-level (H, W) list; level l = round(dim / scale^l)."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale_factor ** l)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Bilinear resampling as a constant [n_out, n_in] matrix (half-pixel
    centers, clamped edges); the JAX package's formulation, kept as the
    definition the taps below are read from."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x = np.clip(x, 0.0, n_in - 1)
    x0 = np.floor(x).astype(np.int64)
    x1 = np.minimum(x0 + 1, n_in - 1)
    f = (x - x0).astype(np.float32)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), x0] += 1.0 - f
    M[np.arange(n_out), x1] += f
    return M


@functools.lru_cache(maxsize=None)
def _resize_taps(n_out: int, n_in: int):
    """(i0, i1, w0, w1): the two source indices and weights of each row of
    _resize_matrix (w1 = 0 where both taps fall on the clamped edge)."""
    M = _resize_matrix(n_out, n_in)
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(np.clip(x, 0.0, n_in - 1)).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    rows = np.arange(n_out)
    w0 = M[rows, i0].copy()
    w1 = np.where(i1 != i0, M[rows, i1], 0.0).astype(np.float32)
    return i0, i1, w0, w1


@functools.lru_cache(maxsize=None)
def _taps_on(n_out: int, n_in: int, device: torch.device):
    """_resize_taps as tensors on `device` (uploaded once per shape)."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _resize_taps(n_out, n_in))


def _resize_axis(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    i0, i1, w0, w1 = _taps_on(n_out, x.shape[dim], x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    a = x.index_select(dim, i0)
    b = x.index_select(dim, i1)
    return a * w0.reshape(shape) + b * w1.reshape(shape)


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Separable bilinear resize of f32[B, H, W] to [B, h, w]: rows, then
    columns (the order of the JAX package's Ry @ img @ Rx^T)."""
    return _resize_axis(_resize_axis(img, h, 1), w, 2)


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float):
    """img: f32[B, H, W] -> list of f32[B, Hl, Wl], each resized from the
    previous level (the reference's cascaded cv::resize)."""
    _, H, W = img.shape
    shapes = level_shapes(H, W, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        h, w = shapes[l]
        levels.append(resize_bilinear(levels[-1], h, w))
    return levels


def gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """OpenCV getGaussianKernel semantics: exp(-x^2/(2 sigma^2)), normalized."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)
