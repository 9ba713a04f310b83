"""The start of the tracker: map seeding from depth and the fused step.

Two pieces of the JAX package's models/tracking.py, as plain functions with
no map arena and no state machine; both are numpy at their boundary, so
they drive the JAX package's TrackPrograms as well as this port's.

  * `seed_map_from_depth`: RGB-D/stereo-style initialization (reference
    StereoInitialization; Tracker.stereo_initialization) of a single
    keyframe: back-project every valid feature with depth > 0, set its
    normal and scale-invariance distances for one observation (arena
    update_normal_and_depth), and lay the points out as the padded
    local-map block the tracking programs take (Tracker._gather_local_points,
    with the 0.8/1.2 distance band).
  * `fused_track_step`: the body of Tracker.track_fused: velocity
    prediction, projection of the last frame's points, the last-frame ->
    local-block map, ONE fused_step call, the acceptance gates and the
    association/outlier bookkeeping. The arena's n_visible / n_found
    counters are not kept.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

LOCAL_MAP_SLOTS = 4096     # padded local-map point budget for device calls


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
