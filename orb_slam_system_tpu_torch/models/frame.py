"""Frame: per-image feature container + device-side construction.

Port of orb_slam_system_tpu/models/frame.py (reference Frame: ORB extraction,
keypoint undistortion, image bounds, stereo matches and RGB-D depth).
`FrameBuilder.build` (monocular), `build_stereo` and `build_rgbd` run on the
FrameBuilder's device and keep ONE packed f32[N, 16] (monocular) or
f32[N, 18] (stereo, RGB-D) tensor there, in the JAX package's layout:

    0:2 xy (level-0 pixels)   2:4 undistorted xy   4 response   5 angle
    6 octave   7 valid   8:16 the 8 descriptor words, bit-cast to f32
    16 u_right (-1: none)   17 depth in metres (-1: none)

A stereo frame runs ONE extraction over the left and right images stacked
to batch 2 (kernels A and B launch once for the pair), then the stereo
match on the pyramid levels that extraction built. `extract_packed_batch`
packs S monocular images from one extraction at batch S (the
multi-sequence mode's shared front end, parallel/multi_system.py).

The tracking programs consume that tensor directly; the host copy
(`Frame.feats`, the map arena's FrameFeatures) is made lazily. A Frame also
carries the tracker's per-frame state: pose, map-point associations,
outlier flags and the pose relative to its reference keyframe.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import SlamConfig
from orb_slam_system_tpu_torch.mapping.arena import FrameFeatures
from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
from orb_slam_system_tpu_torch.ops.stereo import rgbd_pseudo_stereo, stereo_match
from orb_slam_system_tpu_torch.utils import camera as cam_ops
from orb_slam_system_tpu_torch.utils.metrics import fetch, span
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy


@dataclasses.dataclass
class Frame:
    """One frame's padded feature state (`packed` stays on the device) and
    the tracker's bookkeeping for it."""

    id: int
    timestamp: float
    packed: torch.Tensor                    # f32[N, 16 or 18] on the device
    feats_host: Optional[FrameFeatures] = None
    Tcw: Optional[np.ndarray] = None        # f32[4,4] world->camera
    mp_ids: Optional[np.ndarray] = None     # i64[N] map point per feature
    outlier: Optional[np.ndarray] = None    # bool[N]
    ref_kf_id: int = -1
    # Pose relative to ref_kf_id when the frame was finalized (reference
    # mlRelativeFramePoses): the next frame re-anchors the motion model
    # through it after local BA moved the reference keyframe.
    Tcr_ref: Optional[np.ndarray] = None
    # Localization mode's temporary visual-odometry points (reference
    # UpdateLastFrame): {feature slot -> world position f32[3]} of features
    # matched to depth back-projections that are not in the map.
    vo_points: Optional[dict] = None
    # (tracked, not tracked) close-depth features of a stereo or RGB-D frame
    # that the pipelined chain step tracked, counted on the device.
    chain_close_counts: Optional[tuple] = None

    def __post_init__(self):
        n = self.n_slots
        if self.mp_ids is None:
            self.mp_ids = np.full(n, -1, np.int64)
        if self.outlier is None:
            self.outlier = np.zeros(n, bool)

    @property
    def n_slots(self) -> int:
        return int(self.packed.shape[0])

    @property
    def feats(self) -> FrameFeatures:
        """Host copy of the features (one device->host copy, made once)."""
        if self.feats_host is None:
            self.feats_host = FrameBuilder._unpack_feats(
                fetch(self.packed, "track"))
        return self.feats_host

    @property
    def depth(self) -> Optional[np.ndarray]:
        """Per-slot depth in metres (-1: none); None for a monocular frame."""
        return self.feats.depth

    @property
    def n_valid(self) -> int:
        return int(self.feats.valid.sum())

    def camera_center(self) -> np.ndarray:
        R = self.Tcw[:3, :3]
        return -R.T @ self.Tcw[:3, 3]


class FrameBuilder:
    """Shape-specialized frame construction (extraction + undistortion) on
    one device. n_features overrides the config's budget (the monocular
    initializer extracts twice as many); fused_gather picks the
    extractor's patch route (see ops/extractor.py)."""

    def __init__(self, cfg: SlamConfig, device="cuda",
                 n_features: Optional[int] = None, fused_gather: bool = True):
        set_f32_policy()
        self.cfg = cfg
        self.device = torch.device(device)
        cam = cfg.camera
        orb = cfg.orb
        if n_features is not None:
            orb = dataclasses.replace(orb, n_features=n_features)
        self.extractor = ORBExtractor(orb, cam.height, cam.width,
                                      fused_gather=fused_gather)
        self.scale_factors = self.extractor.scales
        self.sigma2 = (self.scale_factors ** 2).astype(np.float32)
        self.inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        self._scales_dev = torch.from_numpy(self.scale_factors).to(self.device)
        self.bounds = cam_ops.compute_image_bounds(
            cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
            cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
        self._next_id = 0

    @staticmethod
    def _unpack_feats(packed: np.ndarray) -> FrameFeatures:
        """Packed f32[N, 16] or f32[N, 18] (numpy) -> FrameFeatures; u_right
        and depth stay None for a monocular frame."""
        packed = np.ascontiguousarray(packed, dtype=np.float32)
        stereo = packed.shape[1] >= 18
        return FrameFeatures(
            xy=packed[:, 0:2].copy(),
            xy_und=packed[:, 2:4].copy(),
            response=packed[:, 4].copy(),
            angle=packed[:, 5].copy(),
            octave=packed[:, 6].astype(np.int32),
            desc=np.ascontiguousarray(packed[:, 8:16]).view(np.uint32),
            valid=packed[:, 7] > 0.5,
            u_right=packed[:, 16].copy() if stereo else None,
            depth=packed[:, 17].copy() if stereo else None,
        )

    def _upload(self, img) -> torch.Tensor:
        """u8/f32 [H, W] or [S, H, W] (numpy or tensor) -> contiguous f32 on
        the device; u8 input uploads as u8 (one copy for all S images) and is
        cast there, any memory layout is taken (the kernels need a
        contiguous image)."""
        return torch.as_tensor(img).to(self.device).to(torch.float32).contiguous()

    def _undistort(self, xy: torch.Tensor) -> torch.Tensor:
        """Undistorted keypoints f32[B, N, 2] of xy f32[B, N, 2]."""
        k = self.cfg.camera
        return cam_ops.undistort_points(xy, k.fx, k.fy, k.cx, k.cy,
                                        k.k1, k.k2, k.p1, k.p2, k.k3)

    def _pack(self, fs, n_rows: int = 1, extra=(), und=None) -> torch.Tensor:
        """The first n_rows batch entries of a FeatureSet (und: their
        undistorted xy, computed when not given) plus the extra per-slot
        columns f32[n_rows, N] -> packed f32[n_rows, N, 16 + len(extra)]."""
        r = slice(0, n_rows)
        und = self._undistort(fs.xy[r]) if und is None else und
        return torch.cat([
            fs.xy[r], und,
            fs.response[r, :, None], fs.angle[r, :, None],
            fs.octave[r].to(torch.float32)[..., None],
            fs.valid[r].to(torch.float32)[..., None],
            fs.desc[r].view(torch.float32),
            *[c[..., None] for c in extra],
        ], dim=2)

    def extract_packed(self, img) -> torch.Tensor:
        """img: u8/f32 [H, W] -> packed f32[N, 16] on the device."""
        return self._pack(self.extractor(self._upload(img)[None]))[0]

    def extract_packed_batch(self, imgs) -> torch.Tensor:
        """imgs: u8/f32 [S, H, W] (numpy or tensor) -> packed f32[S, N, 16]
        on the device (the JAX package's FrameBuilder._extract_packed_batch):
        one upload, one extraction at batch S (kernel A and kernel B's
        describe mode launch once for all S images), one undistortion and
        pack. Row s equals extract_packed(imgs[s]): the kernels and every
        op after them work per image."""
        with span("track.extract"):
            fs = self.extractor(self._upload(imgs))
            return self._pack(fs, fs.xy.shape[0])

    def extract_packed_stereo(self, left, right) -> torch.Tensor:
        """A rectified pair -> packed f32[N, 18] of the left image: one
        extraction at batch 2 (the reference's two extraction threads), then
        the stereo match on that extraction's pyramid levels."""
        k = self.cfg.camera
        fs, levels = self.extractor.extract(
            torch.stack([self._upload(left), self._upload(right)]))
        u_right, depth = stereo_match(
            [l[0] for l in levels], [l[1] for l in levels],
            fs.xy[0], fs.octave[0], fs.desc[0], fs.valid[0],
            fs.xy[1], fs.octave[1], fs.desc[1], fs.valid[1],
            self._scales_dev, k.bf, 0.0, k.fx)
        return self._pack(fs, 1, (u_right[None], depth[None]))[0]

    def extract_packed_rgbd(self, img, depth_map) -> torch.Tensor:
        """An image and its raw depth map (scaled by 1 / DepthMapFactor,
        reference Tracking.cc:90-96) -> packed f32[N, 18]."""
        df = self.cfg.depth_map_factor
        fs = self.extractor(self._upload(img)[None])
        und = self._undistort(fs.xy[:1])
        if not torch.is_tensor(depth_map):
            depth_map = np.asarray(depth_map, np.float32)   # e.g. TUM's u16
        u_right, depth = rgbd_pseudo_stereo(
            self._upload(depth_map), fs.xy[0], und[0], fs.valid[0],
            self.cfg.camera.bf, 1.0 / df if abs(df) > 1e-5 else 1.0)
        return self._pack(fs, 1, (u_right[None], depth[None]), und)[0]

    def build(self, img, timestamp: float) -> Frame:
        """img: f32/u8 [H, W] grayscale -> Frame whose packed tensor stays
        on the device (no host copy); the span track.extract, as are
        build_stereo's and build_rgbd's."""
        with span("track.extract"):
            return self._frame(self.extract_packed(img), timestamp)

    def build_stereo(self, left, right, timestamp: float) -> Frame:
        """A rectified stereo pair -> Frame (packed f32[N, 18])."""
        with span("track.extract"):
            return self._frame(self.extract_packed_stereo(left, right),
                               timestamp)

    def build_rgbd(self, img, depth_map, timestamp: float) -> Frame:
        """An image and its raw depth map -> Frame (packed f32[N, 18])."""
        with span("track.extract"):
            return self._frame(self.extract_packed_rgbd(img, depth_map),
                               timestamp)

    def _frame(self, packed: torch.Tensor, timestamp: float) -> Frame:
        f = Frame(id=self._next_id, timestamp=timestamp, packed=packed)
        self._next_id += 1
        return f
