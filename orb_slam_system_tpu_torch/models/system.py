"""System facade: the public API a user constructs and feeds frames to.

Port of orb_slam_system_tpu/models/system.py (reference System) for the
monocular, stereo and RGB-D sensors, with synchronous mapping (the JAX
System's default async_mapping=False): track_monocular, track_stereo or
track_rgbd tracks the frame, then drains the local mapper inline, so
results are the same every run. A stereo or RGB-D map is seeded from the
first frame's depths at metric scale, and its loop closures solve Sim3s
with the scale fixed to 1. Localization mode (activate_localization_mode)
tracks against the map without creating keyframes. Place recognition (vocabulary + keyframe
database) serves relocalization and the reference-keyframe search: the
vocabulary is loaded from `vocabulary_path` (the reference's ORBvoc text
format) or, without one, self-trained from the map's keyframes once there
are five, as the JAX System does. Loop closing runs on each keyframe the
mapper processed (models/loop_closing.py); its global BA solves on a side
thread unless `sync_gba` is set, and a finished solve is applied after the
next frame's mapping, or at shutdown. Trajectory export in the reference's
TUM, keyframe-TUM and KITTI formats.

Not in this port yet: the async mapper, the streaming and pipelined modes,
the viewer, map save/load.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import (Sensor, SlamConfig,
                                              TrackingState, load_settings)
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.mapping.arena import MapArena
from orb_slam_system_tpu_torch.models.local_mapping import LocalMapper
from orb_slam_system_tpu_torch.models.loop_closing import LoopCloser
from orb_slam_system_tpu_torch.models.place_recognition import PlaceRecognition
from orb_slam_system_tpu_torch.models.tracking import Tracker
from orb_slam_system_tpu_torch.utils.metrics import Telemetry
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy
from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary


class System:
    def __init__(self, settings: Union[str, SlamConfig],
                 sensor: Sensor = Sensor.MONOCULAR, device="cuda",
                 vocabulary_path: Optional[str] = None,
                 sync_gba: bool = False):
        set_f32_policy()
        self.sensor = Sensor(sensor)
        self.cfg = (load_settings(settings, self.sensor)
                    if isinstance(settings, str) else settings)
        self.device = torch.device(device)
        self.vocabulary = (Vocabulary.load(vocabulary_path)
                           if vocabulary_path else None)
        self.arena = MapArena()
        self.place_rec = PlaceRecognition(self.vocabulary, device=device)
        self.arena.erase_hooks.append(self.place_rec.on_erase_keyframe)
        self.local_mapper = LocalMapper(self.cfg, self.arena, device,
                                        place_rec=self.place_rec)
        self.loop_closer = LoopCloser(self.cfg, self.arena, self.place_rec,
                                      self.local_mapper, device,
                                      sync_gba=sync_gba)
        self.local_mapper.loop_closer = self.loop_closer
        self.tracker = Tracker(self.cfg, self.arena, self.local_mapper, device,
                               place_rec=self.place_rec)
        self._timings: list[float] = []
        # Per-frame records: state, tracked points, map size, loops closed,
        # global BAs applied, track_ms, mapping_ms (host clock; both end in
        # a device fetch).
        self.telemetry = Telemetry()

    def track_monocular(self, img: np.ndarray, timestamp: float):
        """Reference TrackMonocular. img: grayscale or RGB (converted);
        returns Tcw (4x4) or None."""
        self._check_sensor(Sensor.MONOCULAR, "track_monocular")
        return self._track(self.tracker.grab_monocular, timestamp,
                           self._gray(img), timestamp)

    def track_stereo(self, img_left: np.ndarray, img_right: np.ndarray,
                     timestamp: float):
        """Reference TrackStereo: a rectified pair, grayscale or RGB
        (converted); returns Tcw (4x4) or None."""
        self._check_sensor(Sensor.STEREO, "track_stereo")
        return self._track(self.tracker.grab_stereo, timestamp,
                           self._gray(img_left), self._gray(img_right),
                           timestamp)

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float):
        """Reference TrackRGBD: an image, grayscale or RGB (converted), and
        its raw depth map (DepthMapFactor units); returns Tcw (4x4) or
        None."""
        self._check_sensor(Sensor.RGBD, "track_rgbd")
        return self._track(self.tracker.grab_rgbd, timestamp, self._gray(img),
                           depth, timestamp)

    TrackMonocular = track_monocular
    TrackStereo = track_stereo
    TrackRGBD = track_rgbd

    def _check_sensor(self, sensor: Sensor, call: str):
        if self.sensor != sensor:
            raise RuntimeError(f"{call} called on a {self.sensor.name} system")

    def _gray(self, img: np.ndarray) -> np.ndarray:
        return rgb_to_gray(img, self.cfg.camera.rgb) if img.ndim == 3 else img

    def _track(self, grab, timestamp: float, *args):
        """Track one frame through grab(*args), drain the mapper, apply a
        finished global BA and record the frame's telemetry."""
        t0 = time.perf_counter()
        Tcw = grab(*args)
        t1 = time.perf_counter()
        self.local_mapper.process_pending()
        self.loop_closer.poll_gba()
        t2 = time.perf_counter()
        self._timings.append(t2 - t0)
        self.telemetry.emit(
            t=timestamp, state=int(self.tracker.state),
            n_inliers=self.tracker.n_inliers,
            n_tracked=len(self.get_tracked_map_points()),
            n_kfs=self.arena.n_keyframes(), n_mps=self.arena.n_points(),
            loops=self.loop_closer.n_loops_closed,
            gba_applied=self.loop_closer.n_gba_applied,
            track_ms=(t1 - t0) * 1e3, mapping_ms=(t2 - t1) * 1e3)
        return Tcw

    def activate_localization_mode(self):
        """Reference ActivateLocalizationMode: tracking goes on, no
        keyframes are made (the mapper gets nothing to do)."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False
        self.tracker.mb_vo = False

    ActivateLocalizationMode = activate_localization_mode
    DeactivateLocalizationMode = deactivate_localization_mode

    def reset(self):
        self.tracker.reset()

    def shutdown(self):
        """Reference Shutdown: drain the mapping queue, wait for a global
        BA in flight and apply it."""
        self.local_mapper.process_pending()
        self.loop_closer.gba.join()
        self.loop_closer.poll_gba()

    Reset = reset
    Shutdown = shutdown

    def get_tracking_state(self) -> TrackingState:
        return self.tracker.state

    def get_tracked_map_points(self):
        cur = self.tracker.current
        if cur is None:
            return []
        return [int(m) for m in cur.mp_ids if m >= 0]

    def get_tracked_keypoints_un(self):
        cur = self.tracker.current
        if cur is None:
            return np.zeros((0, 2), np.float32)
        return cur.feats.xy_und[cur.feats.valid]

    def save_trajectory_tum(self, path: str):
        traj_io.save_trajectory_tum(path, self.arena, self.tracker.trajectory)

    def save_keyframe_trajectory_tum(self, path: str):
        traj_io.save_keyframe_trajectory_tum(path, self.arena)

    def save_trajectory_kitti(self, path: str):
        traj_io.save_trajectory_kitti(path, self.arena, self.tracker.trajectory)

    SaveTrajectoryTUM = save_trajectory_tum
    SaveKeyFrameTrajectoryTUM = save_keyframe_trajectory_tum
    SaveTrajectoryKITTI = save_trajectory_kitti

    def timing_report(self):
        """Median/mean per-frame time (tracking + mapping), the report the
        reference drivers print at exit."""
        if not self._timings:
            return {"median_s": 0.0, "mean_s": 0.0}
        t = np.sort(np.asarray(self._timings))
        return {"median_s": float(t[len(t) // 2]), "mean_s": float(t.mean())}


def rgb_to_gray(img: np.ndarray, rgb_order: bool = True) -> np.ndarray:
    """cvtColor equivalent (reference Tracking.cc:155-160)."""
    img = img.astype(np.float32)
    if rgb_order:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
    else:
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b
