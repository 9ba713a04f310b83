"""Tracking: the per-frame state machine, and the steady-state step.

Port of orb_slam_system_tpu/models/tracking.py (reference Tracking),
monocular, with the synchronous local mapper: grayscale frames in, camera
poses out. Tracker drives two-view initialization (the mixin in
models/tracking_init.py, with the keyframe policy), the fused steady-state
step with its fallbacks (motion model, then the reference keyframe, then
the local map), relocalization of a LOST frame, keyframe creation, reset
and the trajectory log.

Relocalization (reference Tracking::Relocalization) takes the BoW
candidates from the place-recognition service's keyframe database, matches
all of them against the frame in ONE node-constrained search, solves all
the viable ones in ONE batched EPnP-RANSAC (solvers/pnp.py), then tries
them in candidate order: pose LM, projection top-up, pose LM with the
50-inlier gate. The reference-keyframe search uses the frame's and the
keyframe's real vocabulary nodes once place recognition is ready.

The pose-epoch contract (models/loop_closing.py's docstring): a frame
records the map's pose epoch when it starts, and _store_trajectory refuses
to store a relative pose after a map-wide pose rewrite landed inside the
frame (counted in epoch_violations, then raised). With mapping and loop
closing synchronous they run after the frame, so the count stays 0; the
check guards the contract.

Not in this port yet: the pipelined chain mode, localization mode (and
with it the JAX tracker's temporary VO points), stereo and RGB-D.

Two plain functions from the first slice stay beside the Tracker:

  * `seed_map_from_depth`: RGB-D/stereo-style initialization (reference
    StereoInitialization; Tracker.stereo_initialization) of a single
    keyframe: back-project every valid feature with depth > 0, set its
    normal and scale-invariance distances for one observation (arena
    update_normal_and_depth), and lay the points out as the padded
    local-map block the tracking programs take (Tracker._gather_local_points,
    with the 0.8/1.2 distance band).
  * `fused_track_step`: the body of Tracker.track_fused with no arena:
    velocity prediction, projection of the last frame's points, the last
    frame -> local-block map, ONE fused_step call, the acceptance gates and
    the association/outlier bookkeeping. The arena's n_visible / n_found
    counters are not kept.
Both are numpy at their boundary, so they drive the JAX package's
TrackPrograms as well as this port's.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import SlamConfig, TrackingState
from orb_slam_system_tpu_torch.dataio.trajectory import _resolve_ref_pose
from orb_slam_system_tpu_torch.mapping.arena import MapArena
from orb_slam_system_tpu_torch.models.frame import Frame, FrameBuilder
from orb_slam_system_tpu_torch.models.track_device import TrackPrograms, unpack
from orb_slam_system_tpu_torch.models.tracking_init import MonoInitAndKeyframes
from orb_slam_system_tpu_torch.ops import matching
from orb_slam_system_tpu_torch.solvers import pnp
from orb_slam_system_tpu_torch.solvers.initializer import make_ransac_sets
from orb_slam_system_tpu_torch.utils.interop import to_device
from orb_slam_system_tpu_torch.utils.metrics import StageTimer
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy

LOCAL_MAP_SLOTS = 4096     # padded local-map point budget for device calls
MAX_LOCAL_KEYFRAMES = 80   # reference src/Tracking.cc:759-761
RELOC_TOPUP_RADIUS = 10.0  # relocalization's projection search (:863)


class LocalMap(NamedTuple):
    """Padded local-map block (rows beyond len(ids) are padding)."""

    ids: np.ndarray        # i64[K] map point id of each filled row
    pos: np.ndarray        # f32[P,3] world position
    normal: np.ndarray     # f32[P,3] mean viewing direction
    mind: np.ndarray       # f32[P] 0.8 * min_dist
    maxd: np.ndarray       # f32[P] 1.2 * max_dist
    desc: np.ndarray       # u32[P,8]
    valid: np.ndarray      # bool[P]


class TrackResult(NamedTuple):
    """An accepted fused step."""

    Tcw: np.ndarray        # f32[4,4]
    mp_ids: np.ndarray     # i64[N] map point per current feature (-1 none)
    outlier: np.ndarray    # bool[N]
    n_matched: int         # motion-stage matches
    n_in1: int             # motion-stage pose inliers
    n_in2: int             # final pose inliers
    n_valid: int           # valid current features


def seed_map_from_depth(feats, Tcw, depth_map, cam, scale_factors,
                        local_slots: int = LOCAL_MAP_SLOTS):
    """Seed a map from one frame with known depth.

    feats: FrameFeatures-like (xy, xy_und, octave, desc u32, valid);
    Tcw: f32[4,4] pose of the frame; depth_map: f32[H,W] metric depth (0 =
    none), read at the rounded raw keypoint pixel like the RGB-D front end;
    cam: CameraConfig; scale_factors: f32[L].

    Returns (LocalMap, mp_ids i64[N]): point k (id k) comes from feature
    slot mp_ids == k, in ascending slot order, at most local_slots points."""
    H, W = depth_map.shape
    xi = np.clip(np.round(feats.xy[:, 0]).astype(np.int64), 0, W - 1)
    yi = np.clip(np.round(feats.xy[:, 1]).astype(np.int64), 0, H - 1)
    z = depth_map[yi, xi].astype(np.float32)
    slots = np.nonzero(np.asarray(feats.valid) & (z > 0))[0][:local_slots]
    Tcw = np.asarray(Tcw, np.float32)
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    center = -R.T @ t                       # camera centre in the world
    n_levels = len(scale_factors)
    P = local_slots
    out = LocalMap(ids=np.arange(len(slots), dtype=np.int64),
                   pos=np.zeros((P, 3), np.float32),
                   normal=np.zeros((P, 3), np.float32),
                   mind=np.zeros(P, np.float32), maxd=np.zeros(P, np.float32),
                   desc=np.zeros((P, 8), np.uint32), valid=np.zeros(P, bool))
    mp_ids = np.full(feats.xy.shape[0], -1, np.int64)
    for k, i in enumerate(slots):
        zi = float(z[i])
        u, v = feats.xy_und[i]
        xc = np.array([(u - cam.cx) / cam.fx * zi,
                       (v - cam.cy) / cam.fy * zi, zi], np.float32)
        pos = (R.T @ (xc - t)).astype(np.float32)
        # update_normal_and_depth with the single observation.
        d = pos.astype(np.float64) - center
        dist = float(np.linalg.norm(d))
        normal = d / dist if dist > 1e-9 else np.zeros(3)
        max_dist = dist * float(scale_factors[int(feats.octave[i])])
        min_dist = max_dist / float(scale_factors[n_levels - 1])
        out.pos[k] = pos
        out.normal[k] = normal.astype(np.float32)
        out.mind[k] = 0.8 * min_dist       # reference band
        out.maxd[k] = 1.2 * max_dist       # (src/MapPoint.cc:341-351)
        out.desc[k] = feats.desc[i]
        out.valid[k] = True
        mp_ids[i] = k
    return out, mp_ids


def _block_rows(local_map: LocalMap, mp_ids: np.ndarray) -> np.ndarray:
    """Row of each map point id in the local block, -1 where absent."""
    ids = np.asarray(local_map.ids, np.int64)
    order = np.argsort(ids)
    li = np.clip(np.searchsorted(ids[order], mp_ids), 0, len(ids) - 1)
    found = (ids[order][li] == mp_ids) & (mp_ids >= 0)
    return np.where(found, order[li], -1)


def fused_track_step(programs, packed_last, packed_cur, last_Tcw,
                     last_mp_ids, velocity, local_map: LocalMap,
                     cam) -> Optional[TrackResult]:
    """One steady-state tracking step through `programs.fused_step`.

    packed_last / packed_cur: the two frames' packed feature buffers in the
    programs' own array type (handed through untouched); everything else is
    numpy. With no arena, the local block is the whole map: the last
    frame's points are read from it. Returns None where
    Tracker.track_fused falls back to the two-step path (too few last-frame
    points, or a weak result at one of the gates n_matched < 20,
    n_in1 < 10, n_in2 < 30; the stricter gate right after a
    relocalization comes with relocalization)."""
    ids = np.asarray(local_map.ids, np.int64)
    if len(ids) == 0:
        return None
    # The last frame's map points: positions, and their block rows
    # (last2local) so the local-map stage skips what motion matched.
    rows = _block_rows(local_map, last_mp_ids)
    ok = rows >= 0
    if ok.sum() < 10:
        return None
    pos = np.zeros((len(rows), 3), np.float32)
    pos[ok] = local_map.pos[rows[ok]]
    Tcw_pred = (np.asarray(velocity) @ np.asarray(last_Tcw)).astype(np.float32)
    Xc = pos @ Tcw_pred[:3, :3].T + Tcw_pred[:3, 3]
    z = Xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        proj = Xc[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9, z[:, None])
    proj = proj * [cam.fx, cam.fy] + [cam.cx, cam.cy]
    ok = ok & (z > 0)
    last2local = rows.astype(np.int32)
    (T2, best_j, matched, inlier1, idx2, _visible, _already, inlier2,
     n_in1, n_matched, n_valid, n_in2) = programs.fused_step(
        proj, ok, pos, packed_last, packed_cur, Tcw_pred,
        local_map.pos, local_map.normal, local_map.mind, local_map.maxd,
        local_map.desc, local_map.valid, last2local)
    if n_matched < 20 or n_in1 < 10 or n_in2 < 30:
        return None
    mp_ids = np.full(len(last_mp_ids), -1, np.int64)
    good = matched & inlier1
    mp_ids[best_j[good]] = last_mp_ids[good]
    for k in np.nonzero(idx2 >= 0)[0]:       # last writer wins
        if k < len(ids):
            mp_ids[idx2[k]] = ids[k]
    outlier = (mp_ids >= 0) & ~inlier2
    mp_ids[outlier] = -1
    return TrackResult(Tcw=T2, mp_ids=mp_ids, outlier=outlier,
                       n_matched=n_matched, n_in1=n_in1, n_in2=n_in2,
                       n_valid=n_valid)


@dataclasses.dataclass
class TrajectoryEntry:
    """Per-frame relative pose record (reference mlRelativeFramePoses)."""

    Tcr: np.ndarray
    ref_kf_id: int
    timestamp: float
    lost: bool


class Tracker(MonoInitAndKeyframes):
    """Reference Tracking, monocular, on one device (the CPU only when the
    caller asks for it)."""

    def __init__(self, cfg: SlamConfig, arena: MapArena, local_mapper,
                 device="cuda", place_rec=None):
        set_f32_policy()
        self.cfg = cfg
        self.arena = arena
        self.local_mapper = local_mapper
        self.place_rec = place_rec
        self.device = torch.device(device)
        self.state = TrackingState.NO_IMAGES_YET
        self.builder = FrameBuilder(cfg, device)
        # Mono init uses a 2x-features extractor (reference Tracking.cc:76-82).
        self.init_builder = FrameBuilder(
            cfg, device, n_features=2 * cfg.orb.n_features)
        self.programs = TrackPrograms(
            cfg, self.builder.extractor.n_slots, LOCAL_MAP_SLOTS,
            self.builder.bounds, device)
        self.scale_factors = self.builder.scale_factors
        self.inv_sigma2 = self.builder.inv_sigma2
        self.velocity: Optional[np.ndarray] = None
        self.last_frame: Optional[Frame] = None
        self.current: Optional[Frame] = None
        self.init_ref: Optional[Frame] = None
        self.prev_matched: Optional[np.ndarray] = None
        self.ref_kf_id = -1
        self.last_kf_frame_id = -1
        self.last_kf_id = -1
        self.trajectory: list[TrajectoryEntry] = []
        self.max_frames = int(cfg.camera.fps)
        self.min_frames = 0
        self._ransac = self._tensor(make_ransac_sets(
            self.init_builder.extractor.n_slots, 200, 8, seed=0))
        self.n_inliers = 0
        self.local_kf_ids: list[int] = []
        # ((local keyframe ids, arena.version) -> padded local-map block)
        self._local_block_cache = None
        # Wall time per stage of the steady-state path.
        self.stage_ms = StageTimer()
        self.frames_since_reloc = 10 ** 9
        # Relocalization funnel: attempts, no_candidates, no_viable_pnp,
        # all_candidates_failed, ok.
        self.reloc_stats = Counter()
        # arena.pose_epoch when the current frame started.
        self._frame_epoch = arena.pose_epoch
        self.epoch_violations = 0

    def _tensor(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    # ---- entry point -------------------------------------------------------

    def grab_monocular(self, img: np.ndarray, timestamp: float):
        """Reference GrabImageMonocular + Track. Returns Tcw (4x4) or None."""
        self.current = self.build_frame(img, timestamp)
        self.track()
        return None if self.current.Tcw is None else self.current.Tcw.copy()

    def build_frame(self, img: np.ndarray, timestamp: float) -> Frame:
        """Frame construction with the builder the state calls for (the
        2x-features one until the map is initialized)."""
        builder = (self.init_builder
                   if self.state in (TrackingState.NO_IMAGES_YET,
                                     TrackingState.NOT_INITIALIZED)
                   else self.builder)
        return builder.build(img, timestamp)

    def track(self):
        self._frame_epoch = self.arena.pose_epoch
        if self.state == TrackingState.NO_IMAGES_YET:
            self.state = TrackingState.NOT_INITIALIZED
        if self.state == TrackingState.NOT_INITIALIZED:
            self.monocular_initialization()
            self._store_trajectory()
            self.last_frame = self.current
            return
        ok = False
        fused_done = False
        if self.state == TrackingState.OK:
            self._reanchor_last_frame()
            with self.stage_ms.stage("replace_updated"):
                self._replace_updated_points(self.last_frame)
            if self.track_fused():
                ok = fused_done = True
            else:
                if self.velocity is not None:
                    ok = self.track_with_motion_model()
                if not ok:
                    ok = self.track_reference_keyframe()
        else:
            with self.stage_ms.stage("relocalization"):
                ok = self.relocalization()
            if ok:
                self.frames_since_reloc = 0
        if ok and not fused_done:
            ok = self.track_local_map()
        self.state = TrackingState.OK if ok else TrackingState.LOST
        if ok:
            # Motion model (reference :216-221).
            if self.last_frame is not None and self.last_frame.Tcw is not None:
                self.velocity = self.current.Tcw @ np.linalg.inv(
                    self.last_frame.Tcw)
            else:
                self.velocity = None
            self.current.mp_ids[self.current.outlier] = -1
            with self.stage_ms.stage("kf_decision"):
                need_kf = self.need_new_keyframe()
            if need_kf:
                with self.stage_ms.stage("kf_create"):
                    self.create_new_keyframe()
            self.frames_since_reloc += 1
        elif self.arena.n_keyframes() <= 5:
            # Lost soon after initialization -> full reset (reference
            # :229-233, Tracking::Reset :887-927).
            self.reset()
        self._store_trajectory()
        self.last_frame = self.current

    # ---- frame-to-frame tracking -------------------------------------------

    def _replace_updated_points(self, frame: Optional[Frame]):
        """Reference CheckReplacedInLastFrame + MapPoint::Replace: rebind
        each of the last frame's associations to the surviving point by
        following the arena's replaced_by chain; culled points drop to -1."""
        if frame is None or frame.mp_ids is None:
            return
        for k, mid in enumerate(frame.mp_ids):
            mid = int(mid)
            if mid < 0 or mid in self.arena.mps:
                continue
            seen = set()
            cur = mid
            while cur not in self.arena.mps:
                rec = self.arena.dead_mps.get(cur)
                nxt = rec.replaced_by if rec is not None else -1
                if nxt < 0 or nxt in seen:
                    cur = -1
                    break
                seen.add(cur)
                cur = nxt
            frame.mp_ids[k] = cur

    def _gather_frame_points(self, frame: Frame):
        """Positions f32[N,3] and presence bool[N] of the map points attached
        to a frame's features (vectorized arena lookup)."""
        pos = np.zeros((frame.n_slots, 3), np.float32)
        rows, ok = self.arena.lookup_points(frame.mp_ids)
        if ok.any():
            pos[ok] = self.arena.point_columns()[1][rows[ok]]
        return pos, ok

    def _reanchor_last_frame(self):
        """UpdateLastFrame's pose re-anchor (reference Tracking.cc:475-481):
        Tcw_last = Tcr_ref @ Tcw_ref(now), so the motion model follows
        local BA's moves of the reference keyframe; a culled reference is
        resolved through the spanning tree as trajectory export does."""
        last = self.last_frame
        if (last is None or last.Tcw is None or last.Tcr_ref is None
                or last.ref_kf_id < 0):
            return
        ref = self.arena.kfs.get(last.ref_kf_id)
        if ref is None:
            T_extra, live = _resolve_ref_pose(self.arena, last.ref_kf_id)
            if live is None:
                return
            last.Tcw = (last.Tcr_ref @ T_extra @ live.Tcw).astype(np.float32)
            return
        last.Tcw = (last.Tcr_ref @ ref.Tcw).astype(np.float32)

    def _project(self, pos, Tcw):
        """Pinhole projection of world points under Tcw (host): (proj
        f32[N,2], in front bool[N])."""
        cam = self.cfg.camera
        Xc = pos @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = Xc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = Xc[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9,
                                        z[:, None])
        return proj * [cam.fx, cam.fy] + [cam.cx, cam.cy], z > 0

    def track_with_motion_model(self) -> bool:
        """Reference TrackWithMotionModel (:510-547), outlier pruning fixed."""
        cur, last = self.current, self.last_frame
        Tcw_pred = (self.velocity @ last.Tcw).astype(np.float32)
        pos, ok = self._gather_frame_points(last)
        if ok.sum() < 10:
            return False
        proj, front = self._project(pos, Tcw_pred)
        T, best_j, matched, inlier, n_in, n_matched, _ = \
            self.programs.motion_step(proj, ok & front, pos, last.packed,
                                      cur.packed, Tcw_pred, th=15.0)
        if n_matched < 20:
            return False
        # Edge r maps last slot r to current slot best_j[r] (one row per
        # column after the search's dedupe).
        cur.mp_ids[:] = -1
        cur.mp_ids[best_j[matched]] = last.mp_ids[matched]
        cur.Tcw = T
        out = np.zeros(cur.n_slots, bool)
        out[best_j[matched & ~inlier]] = True
        cur.outlier = out
        cur.mp_ids[out] = -1
        self.n_inliers = n_in
        return n_in >= 10

    def track_reference_keyframe(self) -> bool:
        """Reference TrackReferenceKeyFrame (:442-473) with real matching:
        the keyframe's and the frame's direct-index vocabulary nodes
        (SearchByBoW walks the two FeatureVectors in lock-step) once place
        recognition is ready; before that every node id is 0, and the
        node-constrained search is a global ratio-test match. Both sides
        carry real nodes or neither does (the JAX package's round-5 fix:
        real keyframe nodes against all-zero frame nodes matched almost
        nothing)."""
        cur = self.current
        kf = self.arena.kfs.get(self.ref_kf_id)
        if kf is None:
            return False
        has_mp = kf.mp_ids >= 0
        _, c_ang, _, c_valid, c_desc, _ = unpack(cur.packed)
        if (kf.node_ids is not None and self.place_rec is not None
                and self.place_rec.ready):
            node_kf = np.where(has_mp, kf.node_ids, -1)
            node_cur = self.place_rec.vocab.transform_device(c_desc, c_valid)[2]
        else:
            node_kf = np.where(has_mp, 0, -1)
            node_cur = torch.zeros(cur.n_slots, dtype=torch.int32,
                                   device=self.device)
        res = matching.search_by_node_id(
            self._tensor(kf.feats.desc), self._tensor(kf.feats.valid & has_mp),
            self._tensor(kf.feats.angle), self._tensor(node_kf),
            c_desc, c_valid, c_ang, node_cur.to(torch.int64))
        idx2 = res.idx2.cpu().numpy()
        rows = np.nonzero(idx2 >= 0)[0]
        if len(rows) < 15:
            return False
        cur.mp_ids[:] = -1
        cur.mp_ids[idx2[rows]] = kf.mp_ids[rows]
        T0 = (self.last_frame.Tcw if self.last_frame.Tcw is not None
              else kf.Tcw).astype(np.float32)
        return self._optimize_current_pose(T0, min_map_matches=10)

    def _optimize_current_pose(self, T0, min_map_matches=10) -> bool:
        """PoseOptimization + outlier pruning on the current frame."""
        cur = self.current
        pos, ok = self._gather_frame_points(cur)
        xy, _, octv, _, _, ur = unpack(cur.packed)
        T, inlier, _ = self.programs._pose_opt(
            self._tensor(T0), self._tensor(pos), xy,
            self.programs.inv_sigma2[octv], self._tensor(ok), ur)
        out = torch.cat([T.reshape(-1), inlier.float()]).cpu().numpy()
        cur.Tcw = out[:16].reshape(4, 4).astype(np.float32)
        inlier = out[16:] > 0.5
        bad = ok & ~inlier
        cur.outlier = bad
        cur.mp_ids[bad] = -1
        self.n_inliers = int(inlier.sum())
        return self.n_inliers >= min_map_matches

    # ---- local map tracking (reference :549-695, :719-794) -----------------

    def update_local_keyframes(self) -> bool:
        """Reference UpdateLocalKeyFrames: keyframes observing the current
        frame's points (by shared-point count), then their covisibility /
        spanning-tree neighbours, at most 80; the reference keyframe is the
        one sharing the most points."""
        cur = self.current
        counts: dict[int, int] = {}
        for mid in cur.mp_ids:
            if mid < 0:
                continue
            mp = self.arena.mps.get(int(mid))
            if mp is None or mp.bad:
                continue
            for kf_id in mp.obs:
                counts[kf_id] = counts.get(kf_id, 0) + 1
        if not counts:
            return False
        obs_sorted = sorted(counts, key=lambda k: (-counts[k], k))
        local = list(obs_sorted)
        seen = set(local)

        def _add(kf_id):
            if kf_id not in seen:
                seen.add(kf_id)
                local.append(kf_id)

        for kf_id in obs_sorted:
            if len(local) > MAX_LOCAL_KEYFRAMES:
                break
            kf = self.arena.kfs.get(kf_id)
            if kf is None:
                continue
            for nb in self.arena.covisible_ordered(kf, 10):
                _add(nb)
            for c in kf.children:
                _add(c)
            if kf.parent >= 0:
                _add(kf.parent)
        sel = [k for k in local if k in self.arena.kfs][:MAX_LOCAL_KEYFRAMES]
        self.local_kf_ids = sorted(sel)
        self.ref_kf_id = max(counts, key=counts.get)
        cur.ref_kf_id = self.ref_kf_id
        return True

    def _gather_local_points(self):
        """The padded local-map block of the local keyframes' points, cached
        on (local keyframe set, arena.version): between map mutations it is
        reused as is. At most LOCAL_MAP_SLOTS points; when the cap binds the
        least-observed go first. Returns (ids, pos, normal, mind, maxd,
        desc u32, valid)."""
        key = (tuple(self.local_kf_ids), self.arena.version)
        if (self._local_block_cache is not None
                and self._local_block_cache[0] == key):
            return self._local_block_cache[1]
        id_arrays = [self.arena.kfs[k].mp_ids for k in self.local_kf_ids
                     if k in self.arena.kfs]
        if id_arrays:
            all_ids = np.concatenate(id_arrays)
            uniq = np.unique(all_ids[all_ids >= 0])
        else:
            uniq = np.empty(0, np.int64)
        cols = self.arena.point_columns()
        ids_sorted = cols[0]
        if len(ids_sorted):
            srch = np.clip(np.searchsorted(ids_sorted, uniq), 0,
                           len(ids_sorted) - 1)
            found = ids_sorted[srch] == uniq
        else:
            srch = np.zeros(len(uniq), np.int64)
            found = np.zeros(len(uniq), bool)
        sel_rows = srch[found]
        cand_ids = uniq[found]
        if len(cand_ids) > LOCAL_MAP_SLOTS:
            nobs = cols[5][sel_rows]
            keep = np.lexsort((-cand_ids, -nobs))[:LOCAL_MAP_SLOTS]
            keep.sort()
            sel_rows = sel_rows[keep]
            cand_ids = cand_ids[keep]
        ids = [int(m) for m in cand_ids]
        P = LOCAL_MAP_SLOTS
        pos = np.zeros((P, 3), np.float32)
        normal = np.zeros((P, 3), np.float32)
        mind = np.zeros(P, np.float32)
        maxd = np.zeros(P, np.float32)
        desc = np.zeros((P, 8), np.uint32)
        valid = np.zeros(P, bool)
        if ids:
            k = len(ids)
            pos[:k] = cols[1][sel_rows]
            normal[:k] = cols[6][sel_rows]
            mind[:k] = 0.8 * cols[3][sel_rows]   # reference band
            maxd[:k] = 1.2 * cols[4][sel_rows]   # (src/MapPoint.cc:341-351)
            desc[:k] = cols[2][sel_rows]
            valid[:k] = True
        out = (ids, pos, normal, mind, maxd, desc, valid)
        self._local_block_cache = (key, out)
        return out

    def track_local_map(self) -> bool:
        """Reference TrackLocalMap: the local-map search and pose LM in one
        device program, then visibility / found counters and the gates."""
        if not self.update_local_keyframes():
            return False
        cur = self.current
        ids, pos, normal, mind, maxd, desc, valid = self._gather_local_points()
        if not ids:
            return False
        # Points already attached count as visible and found, and stay out
        # of the search (reference SearchLocalPoints :661-678).
        attached = {int(m) for m in cur.mp_ids if m >= 0}
        in_frame = np.zeros(LOCAL_MAP_SLOTS, bool)
        in_frame[:len(ids)] = [mid in attached for mid in ids]
        Xw_pre, ok_pre = self._gather_frame_points(cur)
        T, idx2, visible, inlier, n_in = self.programs.localmap_step(
            pos, normal, mind, maxd, desc, valid & ~in_frame,
            Xw_pre, ok_pre, cur.packed, cur.mp_ids >= 0, cur.Tcw)
        for k in np.nonzero(visible | in_frame)[0]:
            mp = self.arena.mps.get(ids[k])
            if mp is not None:
                mp.n_visible += 1
        for k in np.nonzero(idx2 >= 0)[0]:
            cur.mp_ids[idx2[k]] = ids[k]
        cur.Tcw = T
        out = (cur.mp_ids >= 0) & ~inlier
        cur.outlier = out
        cur.mp_ids[out] = -1
        self.n_inliers = n_in
        self._count_found(cur)
        # Acceptance gates (reference :570-575): stricter for max_frames
        # frames after a relocalization.
        if self.frames_since_reloc < self.max_frames and self.n_inliers < 50:
            return False
        return self.n_inliers >= 30

    def _count_found(self, cur: Frame):
        """IncreaseFound for the frame's inlier points."""
        mps = self.arena.mps
        for mid in cur.mp_ids[(cur.mp_ids >= 0) & ~cur.outlier]:
            mp = mps.get(int(mid))
            if mp is not None:
                mp.n_found += 1

    def track_fused(self):
        """Steady-state tracking in one device program (motion + local-map
        stages, TrackPrograms.fused_step). The local-map block comes from
        the previous frame's final associations (the reference rebuilds it
        from this frame's motion matches), and update_local_keyframes runs
        on this frame's final associations for the next frame. Returns True,
        or None where the exact two-step path must run instead (weak
        result, or not enough prior state)."""
        if (self.velocity is None or not self.local_kf_ids
                or self.last_frame is None):
            return None
        cur, last = self.current, self.last_frame
        t = self.stage_ms
        with t.stage("gather_local"):
            ids, pos_lm, normal, mind, maxd, desc_lm, valid_lm = \
                self._gather_local_points()
        if not ids:
            return None
        with t.stage("gather_frame"):
            pos, ok = self._gather_frame_points(last)
        if ok.sum() < 10:
            return None
        with t.stage("prep"):
            Tcw_pred = (self.velocity @ last.Tcw).astype(np.float32)
            proj, front = self._project(pos, Tcw_pred)
            ok = ok & front
            # last slot -> local block row.
            ids_arr = np.asarray(ids, np.int64)
            order = np.argsort(ids_arr)
            sorted_ids = ids_arr[order]
            li = np.clip(np.searchsorted(sorted_ids, last.mp_ids), 0,
                         len(sorted_ids) - 1)
            found = (sorted_ids[li] == last.mp_ids) & (last.mp_ids >= 0)
            last2local = np.where(found, order[li], -1).astype(np.int32)
        with t.stage("fused_device"):
            (T2, best_j, matched, inlier1, idx2, visible, already, inlier2,
             n_in1, n_matched, _, n_in2) = self.programs.fused_step(
                proj, ok, pos, last.packed, cur.packed, Tcw_pred,
                pos_lm, normal, mind, maxd, desc_lm, valid_lm, last2local)
        # Acceptance gates first (reference :570-575): a weak result falls
        # back to the two-step path with no state changed.
        if (n_matched < 20 or n_in1 < 10 or n_in2 < 30
                or (self.frames_since_reloc < self.max_frames and n_in2 < 50)):
            return None
        with t.stage("bookkeeping"):
            cur.mp_ids[:] = -1
            good = matched & inlier1
            cur.mp_ids[best_j[good]] = last.mp_ids[good]
            for k in np.nonzero(visible | already)[0]:
                if k < len(ids):
                    mp = self.arena.mps.get(ids[k])
                    if mp is not None:
                        mp.n_visible += 1
            for k in np.nonzero(idx2 >= 0)[0]:
                cur.mp_ids[idx2[k]] = ids[k]
            cur.Tcw = T2
            out = (cur.mp_ids >= 0) & ~inlier2
            cur.outlier = out
            cur.mp_ids[out] = -1
            self.n_inliers = n_in2
            self._count_found(cur)
        with t.stage("update_local_kfs"):
            self.update_local_keyframes()
        return True

    # ---- relocalization (reference :796-884) --------------------------------

    def relocalization(self) -> bool:
        """See _relocalization_impl; counts attempts and accepts in
        reloc_stats. (The JAX tracker also hides localization mode's
        temporary VO points here; the port has no localization mode.)"""
        self.reloc_stats["attempts"] += 1
        ok = self._relocalization_impl()
        if ok:
            self.reloc_stats["ok"] += 1
        return ok

    def _relocalization_impl(self) -> bool:
        """Reference Relocalization: BoW candidate keyframes -> BoW matching
        (>= 15) -> EPnP-RANSAC -> pose optimization -> projection top-up ->
        accept at >= 50 inliers. Every candidate (no cap) goes through ONE
        node-constrained search and the viable ones through ONE batched
        EPnP-RANSAC, then a host loop tries them in candidate order, so a
        correct candidate ranked low still relocalizes."""
        if self.place_rec is None or not self.place_rec.ready:
            return False
        cur = self.current
        xy, c_ang, c_oct, c_valid, c_desc, _ = unpack(cur.packed)
        bow, node_ids = self.place_rec.frame_bow(c_desc, c_valid)
        candidates = self.place_rec.db.detect_reloc_candidates(bow, self.arena)
        if not candidates:
            self.reloc_stats["no_candidates"] += 1
            return False
        cand_kfs = [kf for kf in (self.arena.kfs.get(c) for c in candidates)
                    if kf is not None and not kf.bad]
        if not cand_kfs:
            return False
        # ONE node-constrained BoW match over all candidates (keyframes from
        # the 2x-features init builder have more slots: pad).
        C = len(cand_kfs)
        n1 = max(kf.feats.n_slots for kf in cand_kfs)
        desc1 = np.zeros((C, n1, 8), np.uint32)
        has1 = np.zeros((C, n1), bool)
        ang1 = np.zeros((C, n1), np.float32)
        node1 = np.full((C, n1), -1, np.int32)
        for i, kf in enumerate(cand_kfs):
            m = kf.feats.n_slots
            has = (kf.mp_ids >= 0) & kf.feats.valid
            nk = kf.node_ids if kf.node_ids is not None else np.zeros(m, np.int32)
            desc1[i, :m] = kf.feats.desc
            has1[i, :m] = has
            ang1[i, :m] = kf.feats.angle
            node1[i, :m] = np.where(has, nk, -1)
        t = self._tensor
        idx2_all = matching.search_by_node_id(
            t(desc1), t(has1), t(ang1), t(node1), c_desc, c_valid, c_ang,
            node_ids.to(torch.int64), nn_ratio=0.75).idx2.cpu().numpy()
        # Host: per-candidate 3D-2D correspondences on the frame's slots.
        n = cur.n_slots
        Xw_all = np.zeros((C, n, 3), np.float32)
        ok_all = np.zeros((C, n), bool)
        mp_of_slot = np.full((C, n), -1, np.int64)
        viable = []
        for i, kf in enumerate(cand_kfs):
            idx2 = idx2_all[i]
            rows = np.nonzero(idx2[:kf.feats.n_slots] >= 0)[0]
            if len(rows) < 15:            # reference >= 15 gate (:830)
                continue
            for r in rows:
                mid = int(kf.mp_ids[r])
                mp = self.arena.mps.get(mid)
                if mp is not None and not mp.bad:
                    j = idx2[r]
                    Xw_all[i, j] = mp.pos
                    ok_all[i, j] = True
                    mp_of_slot[i, j] = mid
            if ok_all[i].sum() >= 15:
                viable.append(i)
        if not viable:
            self.reloc_stats["no_viable_pnp"] += 1
            return False
        # ONE batched EPnP-RANSAC over the viable candidates.
        cam = self.cfg.camera
        V = len(viable)
        pnp_ok, T_pnp, pnp_inl, _ = pnp.epnp_ransac_batch(
            t(Xw_all[viable]), xy, self.programs.inv_sigma2[c_oct],
            t(ok_all[viable]), t(pnp.make_pnp_sample_sets(n, 300, 0)),
            cam.fx, cam.fy, cam.cx, cam.cy)
        out = torch.cat([pnp_ok.float(), T_pnp.reshape(-1),
                         pnp_inl.float().reshape(-1)]).cpu().numpy()
        pnp_ok = out[:V] > 0.5
        T_pnp = out[V:17 * V].reshape(V, 4, 4)
        pnp_inl = out[17 * V:].reshape(V, n) > 0.5
        # Accept loop in candidate order (the reference iterates until a
        # match); each attempt is two pose optimizations.
        for j, i in enumerate(viable):
            if not pnp_ok[j]:
                continue
            kf = cand_kfs[i]
            cur.mp_ids[:] = -1
            inl = pnp_inl[j]
            cur.mp_ids[inl] = mp_of_slot[i][inl]
            if not self._optimize_current_pose(T_pnp[j], min_map_matches=10):
                continue
            # Projection top-up against the keyframe's full point set
            # (reference :863-880, radius th=10).
            self._reloc_topup(kf)
            if self._optimize_current_pose(cur.Tcw, min_map_matches=50):
                self.ref_kf_id = kf.id
                cur.ref_kf_id = kf.id
                return True
        self.reloc_stats["all_candidates_failed"] += 1
        return False

    def _reloc_topup(self, kf):
        """SearchByProjection of the candidate keyframe's points not yet
        attached to the frame, at the frame's current pose."""
        cur = self.current
        attached = {int(m) for m in cur.mp_ids if m >= 0}
        slots = []
        for mid in kf.mp_ids:
            if mid < 0 or int(mid) in attached:
                continue
            mp = self.arena.mps.get(int(mid))
            if mp is None or mp.bad:
                continue
            slots.append((int(mid), mp))
        if not slots:
            return
        P = len(slots)
        pos = np.stack([mp.pos for _, mp in slots])
        desc = np.stack([mp.desc for _, mp in slots])
        proj, valid = self._project(pos, cur.Tcw)
        radius = np.full(P, RELOC_TOPUP_RADIUS, np.float32)
        already = cur.mp_ids >= 0
        # Predicted octave from the scale-invariance band (PredictScale).
        Ow = -cur.Tcw[:3, :3].T @ cur.Tcw[:3, 3]
        dist = np.linalg.norm(pos - Ow[None, :], axis=1)
        maxd = np.asarray([mp.max_dist for _, mp in slots])
        with np.errstate(divide="ignore", invalid="ignore"):
            lvl = np.ceil(np.log(np.maximum(maxd, 1e-9)
                                 / np.maximum(dist, 1e-9))
                          / np.log(self.cfg.orb.scale_factor))
        lvl = np.clip(np.nan_to_num(lvl, nan=0.0), 0,
                      self.cfg.orb.n_levels - 1).astype(np.int32)
        xy, _, c_oct, c_valid, c_desc, _ = unpack(cur.packed)
        t = self._tensor
        idx2 = matching.search_by_projection_set(
            t(proj.astype(np.float32)), t(radius), t(lvl), t(valid), t(desc),
            xy, c_desc, c_valid, c_oct, t(already)).idx2.cpu().numpy()
        for k in np.nonzero(idx2 >= 0)[0]:
            cur.mp_ids[idx2[k]] = slots[k][0]

    # ---- reset and trajectory (reference :887-927, :239) -------------------

    def reset(self):
        self.local_mapper.reset()
        if self.place_rec is not None:
            self.place_rec.reset()      # reference Tracking::Reset clears the DB
        self._reset_map()
        self.velocity = None
        self.ref_kf_id = -1
        self.last_kf_frame_id = -1
        self.last_kf_id = -1
        self.local_kf_ids = []
        self.state = TrackingState.NOT_INITIALIZED

    def _store_trajectory(self):
        cur = self.current
        if cur is None or cur.Tcw is None or cur.ref_kf_id < 0:
            # Lost / uninitialized frame: repeat the last entry flagged lost.
            if self.trajectory:
                e = self.trajectory[-1]
                self.trajectory.append(TrajectoryEntry(
                    e.Tcr.copy(), e.ref_kf_id, cur.timestamp if cur else 0.0,
                    True))
            return
        # A culled reference resolves through the spanning tree, as the
        # trajectory export does (the JAX tracker drops the frame there).
        T_extra, ref = _resolve_ref_pose(self.arena, cur.ref_kf_id)
        if ref is None:
            return
        if self._frame_epoch != self.arena.pose_epoch:
            self.epoch_violations += 1
            raise RuntimeError(
                f"pose_epoch moved from {self._frame_epoch} to "
                f"{self.arena.pose_epoch} inside frame {cur.id}: a map-wide "
                f"pose rewrite landed inside the frame (loop_closing.py "
                f"docstring); its relative pose would be stale")
        Tcr = (cur.Tcw @ np.linalg.inv(T_extra @ ref.Tcw)).astype(np.float32)
        cur.Tcr_ref = Tcr
        self.trajectory.append(TrajectoryEntry(
            Tcr, cur.ref_kf_id, cur.timestamp, False))
