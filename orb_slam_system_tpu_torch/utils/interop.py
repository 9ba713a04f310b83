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
    return tuple(to_device(a, device)
                 for a in (pos, normal, mind, maxd, desc, valid))


def feature_set_from_numpy(fs, device) -> FeatureSet:
    """A FeatureSet-like with numpy fields (JAX's, desc u32) -> the port's
    FeatureSet on `device`."""
    f = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    return FeatureSet(
        xy=f(fs.xy, np.float32), response=f(fs.response, np.float32),
        angle=f(fs.angle, np.float32), octave=f(fs.octave, np.int32),
        desc=_bits(fs.desc, np.int32).to(device),
        valid=f(fs.valid, np.bool_))


def to_device(a, device) -> torch.Tensor:
    """numpy -> tensor on `device`: uint32 descriptor words become their
    int32 bits, bools stay bool, other integers become int64 and floats
    float32. A read-only array (a JAX array's numpy view) is copied."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device)
    dtype = (torch.bool if a.dtype == np.bool_ else torch.int64
             if np.issubdtype(a.dtype, np.integer) else torch.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def to_numpy(t: torch.Tensor, uint32: bool = False) -> np.ndarray:
    """Tensor -> numpy; uint32=True reinterprets int32 descriptor words as
    the JAX package's uint32 (a view of the same bits)."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint32 else a


def ba_problem_from_numpy(prob, device):
    """A JAX-side BAProblem (or any object with its fields; arrays as JAX
    or numpy arrays) -> the port's BAProblem on `device`."""
    from orb_slam_system_tpu_torch.solvers.local_ba import BAProblem

    fields = {k: to_device(np.asarray(getattr(prob, k)), device)
              for k in BAProblem._fields[:10]}
    e_ur = getattr(prob, "e_ur", None)
    return BAProblem(**fields,
                     e_ur=None if e_ur is None else to_device(np.asarray(e_ur), device),
                     bf=float(getattr(prob, "bf", 0.0)))


def init_inputs_from_numpy(pts1, pts2, matched, ransac_sets, K, device):
    """Two-view initializer inputs (numpy) -> the port's tensors on
    `device`: (pts1 f32[M,2], pts2 f32[M,2], matched bool[M],
    ransac_sets i64[S,8], K f32[3,3])."""
    return tuple(to_device(np.asarray(a), device)
                 for a in (pts1, pts2, matched, ransac_sets, K))
