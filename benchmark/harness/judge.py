"""The numbers that decide `correct`, each against its limit.

Extraction: the keypoints and descriptors of a sample of the window's
frames, drawn from the seed, against the frozen plain extractor
(reference/orb.py) run on the same images once the window has closed.
Tracking: the poses the entry returned in the window against the poses the
frames were rendered from (a monocular map has its own scale, so the
trajectory is aligned by a similarity first, whose scale a stereo or
RGB-D map, metric by nature, should hold at 1); a LOST frame has no pose.
Mapping: the map the mapper built, in the keyframes that observe it.

Each number here is computed from what the program returned and the
reference alone; the limits file of the workload says which numbers are
compared and gives each its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import geometry, orb


def _keyed(xy: np.ndarray, octave: np.ndarray, desc: np.ndarray,
           valid: np.ndarray) -> dict:
    return {(int(o), float(x), float(y)): d
            for (x, y), o, d, v in zip(xy, octave, desc, valid) if v}


def extraction(samples, orb_cfg: dict, device, dtype=torch.float32) -> dict:
    """samples: [(image u8[H, W], program packed f32[N, 16])] of one image
    size. Returns kp_diff_pct (keypoints in one set and not the other, per
    keypoint of the larger set), desc_bits_pct (descriptor bits that differ
    on the keypoints in both) and the reference's features."""
    imgs = torch.as_tensor(np.stack([s[0] for s in samples])).to(device)
    ref = orb.extract(imgs, int(orb_cfg["n_features"]), float(orb_cfg["scale_factor"]),
                      int(orb_cfg["n_levels"]), int(orb_cfg["ini_th_fast"]),
                      int(orb_cfg["min_th_fast"]), dtype=dtype)
    r_xy, r_oct, r_desc, r_valid = (t.cpu().numpy() for t in
                                    (ref.xy, ref.octave, ref.desc, ref.valid))
    missing = total = bits = shared = 0
    for b, (_img, packed) in enumerate(samples):
        p = np.ascontiguousarray(packed, np.float32)
        mine = _keyed(p[:, 0:2], p[:, 6].astype(np.int64),
                      np.ascontiguousarray(p[:, 8:16]).view(np.int32),
                      p[:, 7] > 0.5)
        theirs = _keyed(r_xy[b], r_oct[b], r_desc[b], r_valid[b])
        both = mine.keys() & theirs.keys()
        total += max(len(mine), len(theirs))
        missing += max(len(mine), len(theirs)) - len(both)
        for k in both:
            x = (mine[k].astype(np.int64) ^ theirs[k].astype(np.int64)) & 0xFFFFFFFF
            bits += sum(int(v).bit_count() for v in x)
        shared += len(both)
    return {"kp_diff_pct": 100.0 * missing / max(total, 1),
            "desc_bits_pct": 100.0 * bits / max(256 * shared, 1),
            "reference": ref}


def tracking(cameras) -> dict:
    """cameras: per camera (window frame indices, returned Tcw or None per
    frame, rendered Tcw per frame index). rpe_pct: the aligned estimated
    steps' error per metre of true step, over consecutive tracked frames;
    lost_pct: window frames with no pose; ate_cm: the aligned RMSE;
    scale_err_pct: 100 |s - 1| of the alignment's scale s. ate_cm and
    scale_err_pct take the worst camera."""
    err = tot = 0.0
    lost = n = 0
    ates, scales = [], []
    for frames, poses, truth in cameras:
        n += len(frames)
        ok = [(i, T) for i, T in zip(frames, poses) if T is not None]
        lost += len(frames) - len(ok)
        if len(ok) < 3:
            continue
        est = np.array([geometry.centre(T) for _i, T in ok])
        gt = np.array([geometry.centre(truth[i]) for i, _T in ok])
        idx = [i for i, _T in ok]
        steps = [(a, a + 1) for a in range(len(ok) - 1) if idx[a + 1] == idx[a] + 1]
        e, t = geometry.step_error(est, gt, steps)
        err += e
        tot += t
        ates.append(geometry.ate_rmse(est, gt))
        scales.append(abs(geometry.umeyama(est, gt)[0] - 1.0))
    return {"rpe_pct": 100.0 * err / tot if tot > 0 else float("inf"),
            "lost_pct": 100.0 * lost / max(n, 1),
            "ate_cm": 100.0 * max(ates) if ates else float("inf"),
            "scale_err_pct": 100.0 * max(scales) if scales else float("inf")}


def packed_from(feats, b: int) -> np.ndarray:
    """The program's packed layout (xy, octave, valid, descriptor words) of
    image b of a reference extraction: how the control puts the reference
    in the program's place."""
    n = feats.valid.shape[1]
    p = np.zeros((n, 16), np.float32)
    p[:, 0:2] = feats.xy[b].cpu().numpy()
    p[:, 5] = feats.angle[b].cpu().numpy()
    p[:, 6] = feats.octave[b].cpu().numpy()
    p[:, 7] = feats.valid[b].cpu().numpy()
    p[:, 8:16] = np.ascontiguousarray(feats.desc[b].cpu().numpy()).view(np.float32)
    return p


def mapping(maps, K: np.ndarray, scale: float) -> dict:
    """maps: per camera (keyframes [(timestamp, Tcw, xy_und, octave,
    mp_ids)], points {id: pos}). map_chi2_p95: the 95th percentile of every
    live observation's reprojection chi2 in its keyframe (ORB-SLAM2's sigma
    = scale^octave pixels); map_plane_pct: the rendered ground is a plane,
    so the points' median distance from the plane fitted to them (the
    worst tenth left out of the fit), per the keyframes' median distance
    from it, in %."""
    chi2, flat = [], []
    for kfs, points, *_rest in maps:
        for _ts, Tcw, uv, octave, mp_ids in kfs:
            sel = [(a, m) for a, m in enumerate(mp_ids) if m >= 0 and m in points]
            if not sel:
                continue
            slots = np.array([a for a, _m in sel])
            P = np.array([points[m] for _a, m in sel], np.float64)
            chi2.append(geometry.reprojection_chi2(
                K, np.asarray(Tcw, np.float64), P, uv[slots], octave[slots], scale))
        if len(points) >= 10 and kfs:
            P = np.array(list(points.values()), np.float64)
            C = np.array([geometry.centre(k[1]) for k in kfs])
            flat.append(geometry.planarity(P, C))
    c = np.concatenate(chi2) if chi2 else np.array([np.inf])
    return {"map_chi2_p95": float(np.percentile(c, 95)),
            "map_plane_pct": 100.0 * max(flat) if flat else float("inf")}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    file compares; each must be at most its limit."""
    checks, ok = {}, True
    for name, lim in limits["compare"].items():
        v = float(numbers[name])
        checks[name] = {"value": v, "limit": float(lim["limit"])}
        ok = ok and np.isfinite(v) and v <= float(lim["limit"])
    return ok, checks
