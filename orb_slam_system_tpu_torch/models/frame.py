"""Frame: per-image feature container + device-side construction.

Port of orb_slam_system_tpu/models/frame.py (reference Frame: ORB extraction,
keypoint undistortion, image bounds), monocular only. `FrameBuilder.build`
runs extraction + undistortion on the FrameBuilder's device and keeps ONE
packed f32[N, 16] tensor there, in the JAX package's layout:

    0:2 xy (level-0 pixels)   2:4 undistorted xy   4 response   5 angle
    6 octave   7 valid   8:16 the 8 descriptor words, bit-cast to f32

The tracking programs consume that tensor directly; the host copy
(`Frame.feats`) is made lazily.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import SlamConfig
from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
from orb_slam_system_tpu_torch.utils import camera as cam_ops
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy


@dataclasses.dataclass
class FrameFeatures:
    """Host copy of a frame's padded feature arrays (level-0 coords); the
    JAX package's mapping.arena.FrameFeatures, monocular fields."""

    xy: np.ndarray        # f32[N,2] raw pixel coords
    xy_und: np.ndarray    # f32[N,2] undistorted pixel coords
    response: np.ndarray  # f32[N]
    angle: np.ndarray     # f32[N]
    octave: np.ndarray    # i32[N]
    desc: np.ndarray      # u32[N,8]
    valid: np.ndarray     # bool[N]

    @property
    def n_slots(self) -> int:
        return self.xy.shape[0]


@dataclasses.dataclass
class Frame:
    """One frame's padded feature state; `packed` stays on the device.
    (Pose and map-point bookkeeping live with the caller for now; see
    models/tracking.fused_track_step.)"""

    id: int
    timestamp: float
    packed: torch.Tensor                    # f32[N, 16] on the device
    feats_host: Optional[FrameFeatures] = None

    @property
    def n_slots(self) -> int:
        return int(self.packed.shape[0])

    @property
    def feats(self) -> FrameFeatures:
        """Host copy of the features (one device->host copy, made once)."""
        if self.feats_host is None:
            self.feats_host = FrameBuilder._unpack_feats(
                self.packed.cpu().numpy())
        return self.feats_host


class FrameBuilder:
    """Shape-specialized frame construction (extraction + undistortion) on
    one device."""

    def __init__(self, cfg: SlamConfig, device):
        set_f32_policy()
        self.cfg = cfg
        self.device = torch.device(device)
        cam = cfg.camera
        self.extractor = ORBExtractor(cfg.orb, cam.height, cam.width)
        self.scale_factors = self.extractor.scales
        self.bounds = cam_ops.compute_image_bounds(
            cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
            cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
        self._next_id = 0

    @staticmethod
    def _unpack_feats(packed: np.ndarray) -> FrameFeatures:
        """Packed f32[N, 16] (numpy) -> FrameFeatures."""
        packed = np.ascontiguousarray(packed, dtype=np.float32)
        return FrameFeatures(
            xy=packed[:, 0:2].copy(),
            xy_und=packed[:, 2:4].copy(),
            response=packed[:, 4].copy(),
            angle=packed[:, 5].copy(),
            octave=packed[:, 6].astype(np.int32),
            desc=np.ascontiguousarray(packed[:, 8:16]).view(np.uint32),
            valid=packed[:, 7] > 0.5,
        )

    def extract_packed(self, img) -> torch.Tensor:
        """img: u8/f32 [H, W] (numpy or tensor) -> packed f32[N, 16] on the
        FrameBuilder's device. u8 input uploads as u8 and is cast there."""
        k = self.cfg.camera
        x = torch.as_tensor(img).to(self.device).to(torch.float32)
        fs = self.extractor(x[None])
        und = cam_ops.undistort_points(fs.xy, k.fx, k.fy, k.cx, k.cy,
                                       k.k1, k.k2, k.p1, k.p2, k.k3)
        return torch.cat([
            fs.xy[0], und[0],
            fs.response[0][:, None], fs.angle[0][:, None],
            fs.octave[0].to(torch.float32)[:, None],
            fs.valid[0].to(torch.float32)[:, None],
            fs.desc[0].view(torch.float32),
        ], dim=1)

    def build(self, img, timestamp: float) -> Frame:
        """img: f32/u8 [H, W] grayscale -> Frame whose packed tensor stays
        on the device (no host copy)."""
        f = Frame(id=self._next_id, timestamp=timestamp,
                  packed=self.extract_packed(img))
        self._next_id += 1
        return f
