"""The tracker's initialization and keyframe policy.

Port of the JAX package's models/tracking.py:391-553 (reference
MonocularInitialization, CreateInitialMapMonocular and StereoInitialization)
and :1362-1617 (NeedNewKeyFrame, CreateNewKeyFrame). A monocular map
starts from two views; a stereo or RGB-D map from one frame's depths, at
metric scale, and every later keyframe of those sensors seeds points from
its close depths. A mixin of models.tracking.Tracker, which owns the state
it reads (arena, frames, builders, programs, local mapper, the knobs
below).

With the synchronous mapper the queue is drained after every frame, so the
mapper is idle at each keyframe decision. With the async worker
(System(async_mapping=True)) a keyframe the frame asks for is admitted to
the worker's queue while fewer than `kf_async_queue` wait (upstream's
stereo / RGB-D busy-mapper rule, extended to monocular); on a full queue
the decision waits for the worker to drain it (backpressure, at most
`kf_async_wait_s`, arena.lock and correction_lock released). The wait ends
once the backlog's triangulations landed (`kf_drain_release_on_expansion`),
or, for a frame whose inliers fell below `kf_drain_full_ratio` of the OK
frames' inlier average, once the worker is idle. A keyframe made while the
inliers are below `kf_sync_flush_ratio` of that average flushes the worker
before tracking goes on. Where a loop correction landed during such a wait,
the frame's pose is re-anchored through its pose relative to the reference
keyframe from before the wait.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import Sensor, TrackingState
from orb_slam_system_tpu_torch.models.track_device import unpack
from orb_slam_system_tpu_torch.ops import matching
from orb_slam_system_tpu_torch.solvers.initializer import initialize_two_view
from orb_slam_system_tpu_torch.solvers.local_ba import (
    BAProblem, global_bundle_adjustment)
from orb_slam_system_tpu_torch.utils.metrics import fetch


def _backproject(xy_und: np.ndarray, z: np.ndarray, cam) -> np.ndarray:
    """Camera-frame points f32[N, 3] of undistorted pixels at depths z."""
    return np.stack([(xy_und[:, 0] - cam.cx) / cam.fx * z,
                     (xy_und[:, 1] - cam.cy) / cam.fy * z, z],
                    axis=1).astype(np.float32)


class InitAndKeyframes:
    """Map initialization (two-view, or from depth) and the keyframe
    decision."""

    # ---- initialization (reference Tracking.cc:305-428) -------------------

    def monocular_initialization(self):
        cur = self.current
        if self.init_ref is None:
            if cur.n_valid > 100:
                self.init_ref = cur
                self.prev_matched = cur.feats.xy_und.copy()
            return
        if cur.n_valid <= 100:
            self.init_ref = None
            return
        ref = self.init_ref
        r_xy, r_ang, r_oct, r_valid, r_desc, _ = unpack(ref.packed)
        c_xy, c_ang, c_oct, c_valid, c_desc, _ = unpack(cur.packed)
        res = matching.search_for_initialization(
            r_xy, r_desc, r_valid, r_oct, r_ang,
            c_xy, c_desc, c_valid, c_oct, c_ang,
            prev_matched_xy=self._tensor(self.prev_matched))
        idx2 = fetch(res.idx2, "track")
        matched = idx2 >= 0
        # The viewer's initialization overlay (reference FrameDrawer
        # :27-48): the matched (reference, current) keypoint pairs.
        self.init_vis = (ref.feats.xy_und[matched].copy(),
                         cur.feats.xy_und[idx2[matched]].copy())
        if int(matched.sum()) < 100:           # reference :316-321
            self.init_ref = None
            self.init_vis = None
            return
        # Drift tolerance for the next attempt (reference :323).
        self.prev_matched[matched] = cur.feats.xy_und[idx2[matched]]
        # Slot-aligned match arrays for the batched initializer.
        pts1 = ref.feats.xy_und
        pts2 = np.zeros_like(pts1)
        pts2[matched] = cur.feats.xy_und[idx2[matched]]
        init = initialize_two_view(
            self._tensor(pts1), self._tensor(pts2), self._tensor(matched),
            self._ransac, self._tensor(self.cfg.camera.K))
        M = len(pts1)
        out = fetch(torch.cat([init.success.reshape(1).float(),
                               init.R21.reshape(-1), init.t21,
                               init.points3d.reshape(-1),
                               init.is_triangulated.float()]), "track")
        if out[0] < 0.5:
            return
        good = (out[13 + 3 * M:] > 0.5) & matched
        if good.sum() < 50:
            return
        R21 = out[1:10].reshape(3, 3)
        t21 = out[10:13]
        X = out[13:13 + 3 * M].reshape(M, 3)
        self._create_initial_map(ref, cur, idx2, good, R21, t21, X)

    def _create_initial_map(self, ref, cur, idx2, good, R21, t21, X):
        """Reference CreateInitialMapMonocular (:350-428)."""
        arena = self.arena
        T1 = np.eye(4, dtype=np.float32)
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = R21
        T2[:3, 3] = t21
        kf1 = arena.new_keyframe(ref.id, ref.timestamp, T1, ref.feats)
        kf2 = arena.new_keyframe(cur.id, cur.timestamp, T2, cur.feats)
        for i in np.nonzero(good)[0]:
            j = idx2[i]
            mp = arena.new_point(X[i], cur.feats.desc[j], kf2.id, kf1.id)
            arena.add_observation(mp, kf1, int(i))
            arena.add_observation(mp, kf2, int(j))
            arena.compute_distinctive_descriptor(mp)
            arena.update_normal_and_depth(mp, self.scale_factors)
        arena.update_connections(kf1)
        arena.update_connections(kf2)
        # Global BA over the 2-view map (reference :386, 20 iterations).
        mp_list = list(arena.mps.values())
        P = len(mp_list)
        e_cam, e_pt, e_uv, e_is2 = [], [], [], []
        for p_i, mp in enumerate(mp_list):
            for kf_id, fidx in mp.obs.items():
                kf = arena.kfs[kf_id]
                e_cam.append(0 if kf_id == kf1.id else 1)
                e_pt.append(p_i)
                e_uv.append(kf.feats.xy_und[fidx])
                e_is2.append(self.inv_sigma2[kf.feats.octave[fidx]])
        E = len(e_cam)
        t = self._tensor
        prob = BAProblem(
            Tcw=t(np.stack([kf1.Tcw, kf2.Tcw])),
            cam_fixed=t(np.array([True, False])), cam_valid=t(np.ones(2, bool)),
            points=t(np.stack([mp.pos for mp in mp_list])),
            pt_valid=t(np.ones(P, bool)), e_cam=t(np.asarray(e_cam)),
            e_pt=t(np.asarray(e_pt)), e_uv=t(np.asarray(e_uv, np.float32)),
            e_inv_sigma2=t(np.asarray(e_is2, np.float32)),
            e_valid=t(np.ones(E, bool)))
        cam = self.cfg.camera
        Tcw_opt, X_opt, _ = global_bundle_adjustment(
            prob, cam.fx, cam.fy, cam.cx, cam.cy, n_iters=20)
        buf = fetch(torch.cat([Tcw_opt.reshape(-1), X_opt.reshape(-1)]), "track")
        Tcw_opt = buf[:32].reshape(2, 4, 4)
        X_opt = buf[32:].reshape(P, 3)
        kf1.Tcw = Tcw_opt[0].copy()
        kf2.Tcw = Tcw_opt[1].copy()
        for p_i, mp in enumerate(mp_list):
            arena.set_point_pos(mp, X_opt[p_i])
        # Median-depth normalization (reference :388-405).
        depths = np.array([(kf1.Tcw[:3, :3] @ mp.pos + kf1.Tcw[:3, 3])[2]
                           for mp in mp_list])
        median_depth = float(np.median(depths)) if len(depths) else -1.0
        if median_depth < 0 or kf2.n_tracked_points(arena, 1) < 100:
            self._reset_map()
            return
        inv_md = 1.0 / median_depth
        kf2.Tcw[:3, 3] *= inv_md
        for mp in mp_list:
            arena.set_point_pos(mp, mp.pos * inv_md)
            arena.update_normal_and_depth(mp, self.scale_factors)
        # Wire the current frame into the new map.
        cur.Tcw = kf2.Tcw.copy()
        cur.mp_ids = kf2.mp_ids.copy()
        cur.ref_kf_id = kf2.id
        self.ref_kf_id = kf2.id
        self.last_kf_frame_id = cur.id
        self.last_kf_id = kf2.id
        self.local_mapper.insert_keyframe(kf1.id)
        self.local_mapper.insert_keyframe(kf2.id)
        self.init_ref = None
        self.init_vis = None
        self.state = TrackingState.OK

    def stereo_initialization(self):
        """Reference StereoInitialization (JAX tracking.py:523-553): a frame
        with more than 500 features seeds the map from its depths at the
        identity pose; at least 100 points, or the map is reset."""
        cur = self.current
        if cur.n_valid <= 500:
            return
        cur.Tcw = np.eye(4, dtype=np.float32)
        kf = self.arena.new_keyframe(cur.id, cur.timestamp, cur.Tcw, cur.feats)
        slots = np.nonzero(cur.feats.valid & (cur.depth > 0))[0]
        X = _backproject(cur.feats.xy_und[slots], cur.depth[slots],
                         self.cfg.camera)
        for i, x in zip(slots, X):
            mp = self.arena.new_point(x, cur.feats.desc[i], kf.id, kf.id)
            self.arena.add_observation(mp, kf, int(i))
            self.arena.update_normal_and_depth(mp, self.scale_factors)
            cur.mp_ids[i] = mp.id
        if len(slots) < 100:
            self._reset_map()
            return
        self.arena.update_connections(kf)
        cur.ref_kf_id = kf.id
        self.ref_kf_id = kf.id
        self.last_kf_frame_id = cur.id
        self.last_kf_id = kf.id
        self.local_mapper.insert_keyframe(kf.id)
        self.state = TrackingState.OK

    def _reset_map(self):
        self.arena.kfs.clear()
        self.arena.mps.clear()
        self.arena.dead_mps.clear()
        self.arena.dead_kfs.clear()
        self.arena.kf_origin_id = -1
        self.init_ref = None
        self.init_vis = None
        self.state = TrackingState.NOT_INITIALIZED

    # ---- keyframe decision / creation (reference :578-659) ----------------

    def need_new_keyframe(self) -> bool:
        if self.only_tracking:
            return False
        n_kfs = self.arena.n_keyframes()
        # No keyframe for max_frames frames after a relocalization once
        # the map holds more than max_frames keyframes.
        if self.frames_since_reloc < self.max_frames and n_kfs > self.max_frames:
            return False
        min_obs = 3 if n_kfs > 2 else 2
        ref = self.arena.kfs.get(self.ref_kf_id)
        n_ref_matches = (ref.n_tracked_points(self.arena, min_obs)
                         if ref is not None else 0)
        frames_since_kf = self.current.id - self.last_kf_frame_id
        # c1a: max_frames since the last keyframe; c1b: min_frames since it
        # and the mapper idle (the synchronous mapper always is).
        mapper_idle = self.local_mapper.accepting()
        c1a = frames_since_kf >= self.max_frames
        c1b = frames_since_kf >= self.min_frames and mapper_idle
        # c1c, stereo and RGB-D: too few close points tracked while enough
        # close points are not (reference :590-600).
        mono = self.cfg.sensor == Sensor.MONOCULAR
        c1c = False
        if not mono:
            n_tracked_close, n_nontracked_close = self._close_point_counts()
            c1c = n_tracked_close < 100 and n_nontracked_close > 70
        # Current inliers vs the reference keyframe's tracked points (ratio
        # 0.9 monocular, 0.75 stereo and RGB-D).
        th_ratio = 0.9 if mono else 0.75
        c2 = ((self.n_inliers < n_ref_matches * th_ratio or c1c)
              and self.n_inliers > 15)
        # Bounded-queue admission: the demand is measured without the
        # idleness precondition (a busy mapper must not suppress it).
        c1b_demand = (frames_since_kf >= self.min_frames
                      if self.kf_async_queue else c1b)
        if not ((c1a or c1b_demand or c1c) and c2):
            return False
        if mapper_idle:
            return True
        self.local_mapper.interrupt_ba()
        if not self.kf_async_queue:
            return False
        if len(self.local_mapper.queue) < self.kf_async_queue:
            return True
        # Queue full: drain the backlog rather than drop the demand
        # (dropping healthy frames' demands lost the JAX package's
        # 1250-frame endurance run at every new stretch of the scene).
        return self.kf_async_wait_s > 0 and self._wait_for_mapper_space()

    def _wait_for_mapper_space(self) -> bool:
        """Backpressure: wait, at most kf_async_wait_s, with arena.lock and
        correction_lock released, until the worker drained its whole queue
        (not one slot: a queue kept full leaves mapping that many keyframes
        stale) and its expansion (or, for a fragile frame, all its work).
        A loop correction during the wait re-anchors the frame's pose.
        Returns whether a slot is free; never raises."""
        mapper = self.local_mapper
        t0 = time.monotonic()
        deadline = t0 + self.kf_async_wait_s
        self.kf_wait_stats["waits"] += 1
        cur = self.current
        epoch0 = self.arena.pose_epoch
        ref0 = self.arena.kfs.get(self.ref_kf_id)
        Tcr_pre = None
        if cur is not None and cur.Tcw is not None and ref0 is not None:
            Tcr_pre = cur.Tcw @ np.linalg.inv(ref0.Tcw)
        fragile = self.n_inliers < self.kf_drain_full_ratio * max(
            self._inl_ema, 1.0)
        release_at_expansion = self.kf_drain_release_on_expansion and not fragile
        if fragile:
            self.kf_wait_stats["full_drains"] += 1
        with self.arena.unlocked(), self.arena.correction_unlocked():
            while ((mapper.queue or (mapper._expanding if release_at_expansion
                                     else mapper._busy))
                   and time.monotonic() < deadline):
                time.sleep(0.002)
        if self.arena.pose_epoch != epoch0:
            if Tcr_pre is not None:
                ref = self.arena.kfs.get(self.ref_kf_id)
                if ref is not None:
                    cur.Tcw = (Tcr_pre @ ref.Tcw).astype(np.float32)
                    self._frame_epoch = self.arena.pose_epoch
            elif cur is None or cur.Tcw is None:
                self._frame_epoch = self.arena.pose_epoch
            # Else the pose could not be re-anchored: _frame_epoch stays
            # stale and _store_trajectory refuses the frame.
        self.kf_wait_stats["wait_s"] += time.monotonic() - t0
        ok = len(mapper.queue) < self.kf_async_queue
        if not ok:
            self.kf_wait_stats["timeouts"] += 1
        return ok

    def _close_point_counts(self):
        """(tracked, not tracked) features with a depth below th_depth
        (reference :590-600). A frame the chain step tracked carries the
        counts it made on the device, so its depth column is never
        fetched."""
        cur = self.current
        if cur.chain_close_counts is not None:
            return cur.chain_close_counts
        close = (cur.depth > 0) & (cur.depth < self.cfg.th_depth)
        tracked = (cur.mp_ids >= 0) & ~cur.outlier
        return int((close & tracked).sum()), int((close & ~tracked).sum())

    def create_new_keyframe(self):
        cur = self.current
        kf = self.arena.new_keyframe(cur.id, cur.timestamp, cur.Tcw, cur.feats,
                                     cur.mp_ids)
        cur.ref_kf_id = kf.id
        self.ref_kf_id = kf.id
        self.last_kf_frame_id = cur.id
        self.last_kf_id = kf.id
        if self.cfg.sensor != Sensor.MONOCULAR:
            self._seed_depth_points(kf)
        self.local_mapper.insert_keyframe(kf.id)
        # A keyframe made while tracking is fragile exists to replenish the
        # local map: with the async worker, its triangulations must land
        # before the next frames (the JAX package lost degraded segments
        # otherwise). Flush the worker for this keyframe only.
        if (self.kf_sync_flush_ratio > 0 and self.local_mapper.is_async
                and self.n_inliers < self.kf_sync_flush_ratio * self._inl_ema):
            self.kf_wait_stats["fragile_flushes"] += 1
            epoch0 = self.arena.pose_epoch
            with self.arena.unlocked(), self.arena.correction_unlocked():
                try:
                    self.local_mapper.flush(timeout=60.0)
                except RuntimeError:
                    # The keyframe is queued; a wedged worker slows
                    # tracking down rather than ending it.
                    self.kf_wait_stats["flush_timeouts"] += 1
            if self.arena.pose_epoch != epoch0 and kf.id in self.arena.kfs:
                # A correction landed during the flush and moved the new
                # keyframe with the map: the frame is the same camera.
                cur.Tcw = self.arena.kfs[kf.id].Tcw.copy()
                self._frame_epoch = self.arena.pose_epoch

    def _seed_depth_points(self, kf):
        """Reference CreateNewKeyFrame (:619-659) for stereo and RGB-D: sweep
        every valid feature with a depth, closest first, tracked ones too;
        back-project each untracked one into a new point; stop once a depth
        passes th_depth and more than 100 features were swept."""
        cur = self.current
        d = cur.depth
        slots = np.nonzero(cur.feats.valid & (d > 0))[0]
        slots = slots[np.argsort(d[slots], kind="stable")]
        Twc = np.linalg.inv(cur.Tcw)
        th = self.cfg.th_depth
        for n_points, i in enumerate(slots):
            z = float(d[i])
            if z > th and n_points > 100:
                break
            if cur.mp_ids[i] >= 0:
                continue
            xc = np.append(_backproject(cur.feats.xy_und[i:i + 1], d[i:i + 1],
                                        self.cfg.camera)[0], np.float32(1.0))
            x3d = (Twc @ xc)[:3]
            mp = self.arena.new_point(x3d, cur.feats.desc[i], kf.id, kf.id)
            self.arena.add_observation(mp, kf, int(i))
            self.arena.update_normal_and_depth(mp, self.scale_factors)
            cur.mp_ids[i] = mp.id
            kf.mp_ids[i] = mp.id
            self.local_mapper.recent_points.append((mp.id, kf.id))
