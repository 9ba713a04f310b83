"""Carry the JAX package's arrays into the port's tensors and back.

Arrays arrive as numpy (np.asarray of a JAX array). Descriptor words cross
as raw 32-bit patterns: uint32 words are reinterpreted as int32 with a view,
never converted, and the packed frame's bit-cast descriptor columns (which
can hold NaN patterns) are copied as bytes, never through a float
conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_system_tpu_torch.ops.extractor import FeatureSet


def _bits(a, np_dtype) -> torch.Tensor:
    """numpy array -> tensor holding the same bytes, reinterpreted as the
    32-bit np_dtype (a view, no value conversion)."""
    a = np.ascontiguousarray(np.asarray(a))
    assert a.dtype.itemsize == 4, a.dtype
    return torch.from_numpy(a.view(np_dtype).copy())


def packed_frame_from_numpy(packed, device) -> torch.Tensor:
    """JAX packed frame f32[N, 16] -> the port's tensor on `device`."""
    return _bits(packed, np.float32).to(device)


def local_block_from_numpy(pos, normal, mind, maxd, desc, valid, device):
    """Local-map block (numpy; desc u32[P,8]) -> tensors on `device`, desc
    as int32 bit patterns."""
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return (f(pos), f(normal), f(mind), f(maxd),
            _bits(desc, np.int32).to(device),
            torch.from_numpy(np.asarray(valid, bool).copy()).to(device))


def feature_set_from_numpy(fs, device) -> FeatureSet:
    """A FeatureSet-like with numpy fields (JAX's, desc u32) -> the port's
    FeatureSet on `device`."""
    f = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    return FeatureSet(
        xy=f(fs.xy, np.float32), response=f(fs.response, np.float32),
        angle=f(fs.angle, np.float32), octave=f(fs.octave, np.int32),
        desc=_bits(fs.desc, np.int32).to(device),
        valid=f(fs.valid, np.bool_))


def to_numpy(t: torch.Tensor, uint32: bool = False) -> np.ndarray:
    """Tensor -> numpy; uint32=True reinterprets int32 descriptor words as
    the JAX package's uint32 (a view of the same bits)."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint32 else a
