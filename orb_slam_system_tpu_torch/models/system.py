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

The realtime modes (JAX system.py:197-609):
  * `async_mapping=True` runs the local mapper (and the loop closer it
    hands keyframes to) on a worker thread, the reference's LocalMapping
    thread; keyframes are admitted to its bounded queue, with a
    backpressure drain when it is full (models/tracking_init.py);
  * `track_monocular_stream` keeps one frame in flight: frame i+1 is built
    before frame i is tracked, with the same results as track_monocular;
  * `track_monocular_pipelined`, `track_stereo_pipelined` and
    `track_rgbd_pipelined` keep `depth` frames in flight through the
    device-state chain step (TrackPrograms.chain_step): each step is
    enqueued on the current stream, its packed result copied into a
    pinned host buffer behind it (ChainFetch), and the frame's bookkeeping
    runs `depth` frames later after a wait on that copy's CUDA event. A
    weak chain result, a frame enqueued before a loop correction or a
    global-BA apply (the pose epoch moved), or a tracker that left OK sends
    the frame and those after it through the classic path.
Every Track* call and state getter takes the System's RLock; the lock
order is System._lock > arena.correction_lock > arena.lock. The mapper
worker and the global-BA thread queue their device work on the default
CUDA stream, as tracking does, so the card runs it in one order.

System(..., prewarm=True) runs the warm pass (utils/warmup.py) at its own
config before its first frame, as the JAX System does.

Map persistence: save_map / load_map (mapping/serialize.py's .npz, read
by both packages); a loaded map is relocalized against, by default in
localization mode. The viewer (use_viewer; models/viewer.py) shows each
frame after it is tracked: a live page on localhost, or a status line.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Optional, Union

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import (Sensor, SlamConfig,
                                              TrackingState, load_settings)
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.mapping import serialize
from orb_slam_system_tpu_torch.mapping.arena import MapArena
from orb_slam_system_tpu_torch.models.local_mapping import LocalMapper
from orb_slam_system_tpu_torch.models.loop_closing import LoopCloser
from orb_slam_system_tpu_torch.models.place_recognition import PlaceRecognition
from orb_slam_system_tpu_torch.models.track_device import ChainFetch
from orb_slam_system_tpu_torch.models.tracking import Tracker
from orb_slam_system_tpu_torch.utils.metrics import Telemetry, span, take_spans
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy
from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary


class System:
    def __init__(self, settings: Union[str, SlamConfig],
                 sensor: Sensor = Sensor.MONOCULAR, device="cuda",
                 vocabulary_path: Optional[str] = None,
                 sync_gba: bool = False, async_mapping: bool = False,
                 use_viewer: bool = False, viewer_port: Optional[int] = None,
                 prewarm: bool = False):
        set_f32_policy()
        self.sensor = Sensor(sensor)
        self.cfg = (load_settings(settings, self.sensor)
                    if isinstance(settings, str) else settings)
        self.device = torch.device(device)
        # The warm pass (utils/warmup.py) before this System's first frame:
        # warmup.PREWARM_FRAMES of a synthetic orbit at this config's
        # camera and ORB settings through two throwaway Systems;
        # {mode: seconds}.
        self.warm_seconds: dict = {}
        if prewarm:
            from orb_slam_system_tpu_torch.utils import warmup
            self.warm_seconds = warmup.warm(self.cfg, warmup.PREWARM_FRAMES,
                                            verbose=False, device=device)
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
        # Per-frame records: state, keypoints, inliers, tracked points, map
        # size, track_ms, mapping_ms (host clock; both end in a device
        # fetch), loops closed, global BAs applied, and the frame's spans
        # (utils/metrics.py).
        self.telemetry = Telemetry()
        # Reentrant: the Track* entry points and state getters may be called
        # from several threads (reference mMutexMode / mMutexState).
        self._lock = threading.RLock()
        self.async_mapping = async_mapping
        if async_mapping:
            self.local_mapper.start_async()
        # The reference's Viewer: with a port (0 picks a free one) the live
        # page on localhost, else a status line per frame
        # (models/viewer.py). It reads host copies only.
        self.viewer = None
        if use_viewer:
            from orb_slam_system_tpu_torch.models import viewer
            self.viewer = (viewer.LiveViewer(self, port=viewer_port)
                           if viewer_port is not None
                           else viewer.StatsViewer(self))

    def track_monocular(self, img: np.ndarray, timestamp: float):
        """Reference TrackMonocular. img: grayscale or RGB (converted);
        returns Tcw (4x4) or None."""
        self._check_sensor(Sensor.MONOCULAR, "track_monocular")
        gray = self._gray(img)
        return self._track(self.tracker.grab_monocular, timestamp, gray,
                           timestamp, view=gray)

    def track_stereo(self, img_left: np.ndarray, img_right: np.ndarray,
                     timestamp: float):
        """Reference TrackStereo: a rectified pair, grayscale or RGB
        (converted); returns Tcw (4x4) or None."""
        self._check_sensor(Sensor.STEREO, "track_stereo")
        left = self._gray(img_left)
        return self._track(self.tracker.grab_stereo, timestamp, left,
                           self._gray(img_right), timestamp, view=left)

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float):
        """Reference TrackRGBD: an image, grayscale or RGB (converted), and
        its raw depth map (DepthMapFactor units); returns Tcw (4x4) or
        None."""
        self._check_sensor(Sensor.RGBD, "track_rgbd")
        gray = self._gray(img)
        return self._track(self.tracker.grab_rgbd, timestamp, gray, depth,
                           timestamp, view=gray)

    TrackMonocular = track_monocular
    TrackStereo = track_stereo
    TrackRGBD = track_rgbd

    def _check_sensor(self, sensor: Sensor, call: str):
        if self.sensor != sensor:
            raise RuntimeError(f"{call} called on a {self.sensor.name} system")

    def _gray(self, img: np.ndarray) -> np.ndarray:
        return rgb_to_gray(img, self.cfg.camera.rgb) if img.ndim == 3 else img

    def _track(self, grab, timestamp: float, *args, view=None):
        """Track one frame through grab(*args) under the System's lock, as
        one _frame (view: the image the viewer shows)."""
        with self._lock, self._frame(timestamp, view):
            return grab(*args)

    def _pump_mapping(self):
        """Synchronous mapping: drain the keyframe queue here (the worker
        does it in async mode). Then apply a finished global BA."""
        if not self.async_mapping:
            self.local_mapper.process_pending()
        self.loop_closer.poll_gba()

    @contextlib.contextmanager
    def _frame(self, timestamp: float, view: Optional[np.ndarray] = None):
        """One frame, in the span system.frame: the caller tracks it in the
        body, then mapping is pumped. Once the span closed, the frame's
        telemetry is recorded and `view` shown in the viewer."""
        with span("system.frame"):
            t0 = time.perf_counter()
            yield
            t1 = time.perf_counter()
            self._pump_mapping()
            t2 = time.perf_counter()
        self._record(timestamp, t0, t1, t2)
        if view is not None:
            self._view(view)

    def _record(self, timestamp: float, t0: float, t1: float, t2: float):
        """The telemetry of a frame tracked from t0 to t1 and mapped to t2
        (host clock), with the spans this thread ran since its last record:
        the frame's own, system.frame included."""
        cur = self.tracker.current
        # No fetch for telemetry: the frame's host copy where it has one,
        # else the count the last device step reported.
        n_kp = (int(cur.feats_host.valid.sum())
                if cur is not None and cur.feats_host is not None
                else self.tracker.last_n_valid)
        self.telemetry.emit(
            t=timestamp, state=int(self.tracker.state), n_keypoints=n_kp,
            n_inliers=self.tracker.n_inliers,
            n_tracked=len(self.get_tracked_map_points()),
            n_kfs=self.arena.n_keyframes(), n_mps=self.arena.n_points(),
            track_ms=(t1 - t0) * 1e3, mapping_ms=(t2 - t1) * 1e3,
            loops=self.loop_closer.n_loops_closed,
            gba_applied=self.loop_closer.n_gba_applied, spans=take_spans())

    def _view(self, img: np.ndarray):
        """The viewer's per-frame update (the reference Viewer::Run
        cadence); a viewer failure never stops tracking."""
        if self.viewer is not None:
            try:
                self.viewer.update(img)
            except Exception:  # noqa: BLE001 - the viewer never stops SLAM
                pass

    def track_monocular_prebuilt(self, frame):
        """Track a frame built by tracker.build_frame (or any builder of this
        camera). Returns Tcw (4x4) or None."""
        self._check_sensor(Sensor.MONOCULAR, "track_monocular_prebuilt")
        return self._track(self.tracker.grab_prebuilt, frame.timestamp, frame)

    def track_monocular_stream(self, frames):
        """Track an iterable of (img, timestamp) with one frame in flight:
        frame i+1's extraction is enqueued before frame i is tracked, so the
        card builds the next frame while the host tracks this one. The
        results are those of calling track_monocular on each frame in turn
        (a prebuilt frame is built again when the tracker left OK, since
        the builder depends on the state). Yields Tcw (or None) per frame;
        a frame's track_ms includes the next frame's enqueue."""
        self._check_sensor(Sensor.MONOCULAR, "track_monocular_stream")
        tr = self.tracker
        it = iter(frames)
        pending = None          # (built frame, gray image, timestamp)
        while True:
            if pending is None:
                nxt = next(it, None)
                if nxt is None:
                    return
                img, ts = self._gray(nxt[0]), nxt[1]
                with self._lock:
                    frame = tr.build_frame(img, ts)
            else:
                frame, img, ts = pending
                pending = None
                if tr.state != TrackingState.OK:
                    with self._lock:
                        frame = tr.build_frame(img, ts)
            with self._lock, self._frame(ts, img):
                if tr.state == TrackingState.OK:
                    nxt = next(it, None)
                    if nxt is not None:
                        img2, ts2 = self._gray(nxt[0]), nxt[1]
                        pending = (tr.build_frame(img2, ts2), img2, ts2)
                Tcw = tr.grab_prebuilt(frame)
            yield Tcw

    def track_monocular_pipelined(self, frames, resync_every: int = 0,
                                  depth: int = 2):
        """Track an iterable of (img, timestamp) with `depth` frames in
        flight through the device-state chain step (module docstring).
        The chain engages on a mature map in steady state; everything else,
        and every weak chain result, goes through the classic path.
        resync_every > 0 rebuilds the device state from the host every
        that many frames. Chain frames may differ from track_monocular's
        within matching tolerance (device f32 projection against the host
        path's), so the trajectory is of the same quality, not bit-equal.
        Yields Tcw (or None) per frame, in order."""
        self._check_sensor(Sensor.MONOCULAR, "track_monocular_pipelined")
        tr = self.tracker
        return self._track_pipelined(
            frames, lambda it: tr.builder.build(self._gray(it[0]), it[1]),
            lambda it: tr.build_frame(self._gray(it[0]), it[1]),
            resync_every, depth)

    def track_stereo_pipelined(self, frames, resync_every: int = 0,
                               depth: int = 2):
        """track_monocular_pipelined over (left, right, timestamp) rectified
        pairs: stereo observations enter the chain's pose LM through
        u_right, and the keyframe rule's close-point counts are made on the
        card."""
        self._check_sensor(Sensor.STEREO, "track_stereo_pipelined")
        tr = self.tracker

        def build(it):
            return tr.builder.build_stereo(self._gray(it[0]), self._gray(it[1]),
                                           it[2])
        return self._track_pipelined(frames, build, build, resync_every, depth)

    def track_rgbd_pipelined(self, frames, resync_every: int = 0,
                             depth: int = 2):
        """track_monocular_pipelined over (img, depth map, timestamp)."""
        self._check_sensor(Sensor.RGBD, "track_rgbd_pipelined")
        tr = self.tracker

        def build(it):
            return tr.builder.build_rgbd(self._gray(it[0]), it[1], it[2])
        return self._track_pipelined(frames, build, build, resync_every, depth)

    def _track_pipelined(self, items, build_steady, build_classic,
                         resync_every: int, depth: int):
        """_pipelined_frames, with each frame's image shown in the viewer
        when its pose is yielded (frames come out in order)."""
        if self.viewer is None:
            yield from self._pipelined_frames(items, build_steady,
                                              build_classic, resync_every,
                                              depth)
            return
        shown: deque = deque()

        def tap():
            for it in items:
                shown.append(it[0])
                yield it
        for Tcw in self._pipelined_frames(tap(), build_steady, build_classic,
                                          resync_every, depth):
            with self._lock:
                self._view(self._gray(shown.popleft()))
            yield Tcw

    def _pipelined_frames(self, items, build_steady, build_classic,
                          resync_every: int, depth: int):
        """The pipelined loop (JAX system.py:336-609): build_steady makes a
        chain frame, build_classic one for the classic path (monocular:
        the 2x-features builder until initialized)."""
        tr = self.tracker
        depth = max(1, int(depth))
        fetch = ChainFetch(tr.programs.chain_out_size, depth + 1, self.device)
        pendq: deque = deque()   # (frame, block ids, item, ticket), oldest first
        state = None             # (T_prev, T_last, assoc) on the device
        state_epoch = -1         # arena.pose_epoch the state was made in
        prev_ids = prev_packed = None

        def classic(frame):
            return self._track(tr.grab_prebuilt, frame.timestamp, frame)

        def process_oldest():
            """(Tcw, broke) of the oldest frame in flight. broke: the device
            state is gone, and the frames enqueued on it must be tracked
            again classically."""
            nonlocal state
            frame, ids, _, ticket = pendq.popleft()
            broke = False
            with tr.stage_ms.stage("chain_fetch_wait"):
                host_out = fetch.wait(ticket)
            # correction_lock over the frame's whole commit, as track() has.
            # (Mapping, pumped at the frame's end, leaves the tracker's
            # state as it is.)
            with (self._lock, tr.arena.correction_lock,
                  self._frame(frame.timestamp)):
                with tr.arena.lock:
                    # A correction since the enqueue: the result lives in
                    # the old map frame.
                    ok = (None if tr.arena.pose_epoch != state_epoch
                          else tr.chain_process(frame, ids, host_out))
                    if ok is True and tr.arena.pose_epoch != state_epoch:
                        ok = None
                if ok is True:
                    with tr.arena.lock:
                        tr.chain_finish(frame, True)
                    Tcw = None if frame.Tcw is None else frame.Tcw.copy()
                else:
                    # Classic re-track (track() takes arena.lock itself, so
                    # an internal reset can release it to flush the worker).
                    # None: also drop the state and the frames on it.
                    if ok is None:
                        state = None
                        broke = True
                    Tcw = tr.grab_prebuilt(frame)
                if tr.state != TrackingState.OK:
                    state = None
                    broke = True
            return Tcw, broke

        def drain_classic():
            """Track every frame in flight classically, in order (their steps
            ran on a dropped state); a frame is built again with the
            classic builder when the tracker left OK. Yields each pose."""
            while pendq:
                frame, _, item, _ = pendq.popleft()
                if tr.state != TrackingState.OK:
                    with self._lock:
                        frame = build_classic(item)
                yield classic(frame)

        def drain_all():
            """Process every frame in flight, in order; once one breaks, the
            rest go through drain_classic. Yields each pose."""
            while pendq:
                Tcw, broke = process_oldest()
                yield Tcw
                if broke:
                    yield from drain_classic()

        for item in items:
            with self._lock:
                chain_ok = tr.chain_ready()
            if pendq and (state is None or not chain_ok):
                # The state was dropped or the chain disengaged with frames
                # in flight: finish them first, so the bootstrap below starts
                # from the frame whose packed buffer becomes packed_last.
                yield from drain_all()
                with self._lock:
                    chain_ok = chain_ok and tr.chain_ready()
            if not chain_ok:
                with self._lock:
                    frame = build_classic(item)
                state = None
                yield classic(frame)
                continue
            with self._lock, tr.stage_ms.stage("chain_build"):
                frame = build_steady(item)
            # correction_lock: never enqueue on a half-corrected map.
            with (self._lock, tr.arena.correction_lock, tr.arena.lock,
                  tr.stage_ms.stage("chain_enqueue")):
                if state is None:
                    state, prev_ids = tr.chain_bootstrap()
                    state_epoch = tr.arena.pose_epoch
                    prev_packed = tr.last_frame.packed
                ids, state, packed_out = tr.chain_enqueue(
                    frame, state, prev_packed, prev_ids)
                if resync_every and frame.id % resync_every == 0:
                    state = None     # rebuilt from the host next frame
            pendq.append((frame, ids, item, fetch.issue(packed_out)))
            prev_ids, prev_packed = ids, frame.packed
            if len(pendq) > depth:
                Tcw, broke = process_oldest()
                yield Tcw
                if broke:
                    yield from drain_classic()
        yield from drain_all()

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
        with self._lock:
            self.tracker.reset()

    def shutdown(self):
        """Reference Shutdown: drain the mapping queue (and stop the worker
        in async mode), wait for a global BA in flight and apply it."""
        if self.async_mapping:
            self.local_mapper.flush()
            self.local_mapper.stop_async()
        self.local_mapper.process_pending()
        self.loop_closer.gba.join()
        self.loop_closer.poll_gba()
        if self.viewer is not None and hasattr(self.viewer, "shutdown"):
            self.viewer.shutdown()

    Reset = reset
    Shutdown = shutdown

    def get_tracking_state(self) -> TrackingState:
        with self._lock:
            return self.tracker.state

    def get_tracked_map_points(self):
        with self._lock:
            cur = self.tracker.current
            if cur is None:
                return []
            return [int(m) for m in cur.mp_ids if m >= 0]

    def get_tracked_keypoints_un(self):
        with self._lock:
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

    # ---- map persistence (the reference's TODO, include/System.h:94-96) ----

    def save_map(self, path: str):
        """Write the map to `path` (.npz, mapping/serialize.py's format,
        which the JAX package reads too). Between frames, with the mapping
        worker drained, so no stage is half done in the file."""
        with self._lock:
            self.local_mapper.flush()
            with self.arena.correction_lock:
                serialize.save_map(self.arena, path)

    def load_map(self, path: str, localization_only: bool = True):
        """Replace the map with the one saved at `path` and resume: the
        state becomes LOST, so the next frame relocalizes against it; with
        localization_only (the default) the System then tracks without
        adding keyframes. A load into a System that has tracked gives what
        a load into a fresh one gives.

        Departs from the JAX System.load_map (models/system.py:694-721),
        which swaps arena.kfs / arena.mps without arena.lock while the
        async worker may be mid-stage, bumps neither arena.version nor
        arena.pose_epoch, and keeps the old map's tombstones, the tracker's
        trajectory and caches and the loop closer's detection state: here
        the worker is drained and the global BA dropped first, the swap
        runs under correction_lock and arena.lock, and all of those are
        cleared, so no cache keyed on (keyframe ids, version) serves the
        old map's block to the new map."""
        loaded = serialize.load_map(path)
        with self._lock:
            self.local_mapper.reset()
            self.loop_closer.forget_map()
            arena = self.arena
            with arena.correction_lock, arena.lock:
                arena.kfs, arena.mps = loaded.kfs, loaded.mps
                arena.dead_kfs.clear()
                arena.dead_mps.clear()
                arena.next_kf_id = loaded.next_kf_id
                arena.next_mp_id = loaded.next_mp_id
                arena.kf_origin_id = loaded.kf_origin_id
                arena.version += 1
                arena.pose_epoch += 1
                self.place_rec.rebuild(arena, self.vocabulary)
                self.tracker.forget_map()
            if localization_only:
                self.activate_localization_mode()
            else:
                self.deactivate_localization_mode()

    SaveMap = save_map
    LoadMap = load_map

    def timing_report(self):
        """Median/mean per-frame time (tracking + mapping, from the
        telemetry records), the report the reference drivers print at
        exit."""
        recs = self.telemetry.records
        if not recs:
            return {"median_s": 0.0, "mean_s": 0.0}
        t = np.sort([(r["track_ms"] + r["mapping_ms"]) * 1e-3 for r in recs])
        return {"median_s": float(t[len(t) // 2]), "mean_s": float(t.mean())}


def rgb_to_gray(img: np.ndarray, rgb_order: bool = True) -> np.ndarray:
    """cvtColor equivalent (reference Tracking.cc:155-160)."""
    img = img.astype(np.float32)
    if rgb_order:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
    else:
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b
