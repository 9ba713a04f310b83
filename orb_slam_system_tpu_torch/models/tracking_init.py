"""The tracker's monocular initialization and keyframe policy.

Port of the JAX package's models/tracking.py:391-521 (reference
MonocularInitialization and CreateInitialMapMonocular) and :1362-1583
(NeedNewKeyFrame, CreateNewKeyFrame), monocular, with the synchronous
mapper: mapping drains its queue after every frame, so it is idle at each
keyframe decision and the async admission and backpressure machinery has
nothing to do. A mixin of models.tracking.Tracker, which owns the state it
reads (arena, frames, builders, programs, local mapper).
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import TrackingState
from orb_slam_system_tpu_torch.models.track_device import unpack
from orb_slam_system_tpu_torch.ops import matching
from orb_slam_system_tpu_torch.solvers.initializer import initialize_two_view
from orb_slam_system_tpu_torch.solvers.local_ba import (
    BAProblem, global_bundle_adjustment)


class MonoInitAndKeyframes:
    """Monocular two-view initialization and the keyframe decision."""

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
        idx2 = res.idx2.cpu().numpy()
        matched = idx2 >= 0
        if int(matched.sum()) < 100:           # reference :316-321
            self.init_ref = None
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
        out = torch.cat([init.success.reshape(1).float(),
                         init.R21.reshape(-1), init.t21,
                         init.points3d.reshape(-1),
                         init.is_triangulated.float()]).cpu().numpy()
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
        buf = torch.cat([Tcw_opt.reshape(-1), X_opt.reshape(-1)]).cpu().numpy()
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
        self.state = TrackingState.OK

    def _reset_map(self):
        self.arena.kfs.clear()
        self.arena.mps.clear()
        self.arena.dead_mps.clear()
        self.arena.dead_kfs.clear()
        self.arena.kf_origin_id = -1
        self.init_ref = None
        self.state = TrackingState.NOT_INITIALIZED

    # ---- keyframe decision / creation (reference :578-659) ----------------

    def need_new_keyframe(self) -> bool:
        # (The reference's hold-off right after a relocalization comes
        # with relocalization.)
        min_obs = 3 if self.arena.n_keyframes() > 2 else 2
        ref = self.arena.kfs.get(self.ref_kf_id)
        n_ref_matches = (ref.n_tracked_points(self.arena, min_obs)
                         if ref is not None else 0)
        frames_since_kf = self.current.id - self.last_kf_frame_id
        # c1a: max_frames since the last keyframe; c1b: min_frames since it
        # and the mapper idle, which the synchronous mapper always is here.
        c1a = frames_since_kf >= self.max_frames
        c1b = frames_since_kf >= self.min_frames and self.local_mapper.accepting()
        # Current inliers vs the reference keyframe's tracked points
        # (ratio 0.9, monocular).
        c2 = self.n_inliers < n_ref_matches * 0.9 and self.n_inliers > 15
        return (c1a or c1b) and c2

    def create_new_keyframe(self):
        cur = self.current
        kf = self.arena.new_keyframe(cur.id, cur.timestamp, cur.Tcw, cur.feats,
                                     cur.mp_ids)
        cur.ref_kf_id = kf.id
        self.ref_kf_id = kf.id
        self.last_kf_frame_id = cur.id
        self.last_kf_id = kf.id
        self.local_mapper.insert_keyframe(kf.id)
