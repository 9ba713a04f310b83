"""Fused per-frame tracking programs on the device.

Port of orb_slam_system_tpu/models/track_device.py (motion_step,
localmap_step, fused_step; the pipelined chain_step ports later). The
tracker runs fused_step on a steady frame and falls back to motion_step
(then a reference-keyframe match) and localmap_step when the fused result
is weak:

  * motion stage: motion-model projection search (narrow and widened window
    from ONE distance matrix, the reference's `if(nmatches<20) search again
    with 2*th`) + the 4x10 LM pose optimization;
  * local-map stage: frustum check over the local-map block, projection
    search with the view-cos-dependent radius, association scatter, and the
    final pose optimization (reference TrackLocalMap).

Each host wrapper uploads its per-frame inputs once and fetches ONE packed
f32 result, with the JAX package's argument lists and outputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import SlamConfig
from orb_slam_system_tpu_torch.ops import frustum as frustum_ops
from orb_slam_system_tpu_torch.ops import matching
from orb_slam_system_tpu_torch.ops.hamming import distance_matrix
from orb_slam_system_tpu_torch.solvers.pose_opt import pose_optimization
from orb_slam_system_tpu_torch.utils.interop import (local_block_from_numpy,
                                                     to_device)
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy


def _scatter_last_wins(n_out, idx, valid, n_src):
    """winner[j] = the LARGEST source row i with valid[i] and idx[i] == j,
    else -1: the last-writer-wins of a host loop over ascending i,
    deterministic under duplicate indices."""
    dev = idx.device
    rows = torch.arange(n_src, device=dev)
    # Invalid rows go to a spare slot n_out that is cut off afterwards
    # (a boolean filter would make the card report a count to the host).
    w = torch.where(valid, idx, torch.full_like(idx, n_out)).clamp(0, n_out)
    out = torch.full((n_out + 1,), -1, dtype=torch.int64, device=dev)
    return out.scatter_reduce(0, w, rows, "amax", include_self=True)[:n_out]


def _drop_set(n_out, idx, values, fill, dev):
    """out = fill; out[idx] = values for rows whose idx < n_out (the JAX
    .at[idx].set(..., mode="drop")). Out-of-range rows land in a spare slot
    that is cut off; callers guarantee the in-range idx are unique."""
    out = torch.full((n_out + 1,) + values.shape[1:], fill,
                     dtype=values.dtype, device=dev)
    out.index_put_((idx.clamp(0, n_out),), values)
    return out[:n_out]


def unpack(packed: torch.Tensor):
    """Columns of a packed frame: 2:4 undistorted xy, 5 angle, 6 octave,
    7 valid, 8:16 descriptor words; u_right is -1 (monocular)."""
    xy = packed[:, 2:4]
    ang = packed[:, 5]
    octv = packed[:, 6].to(torch.int64)
    valid = packed[:, 7] > 0.5
    desc = packed[:, 8:16].contiguous().view(torch.int32)
    ur = torch.full((packed.shape[0],), -1.0, device=packed.device)
    return xy, ang, octv, valid, desc, ur


class TrackPrograms:
    """Shape-specialized fused tracking programs for one camera config on
    one device."""

    def __init__(self, cfg: SlamConfig, n_slots: int, local_slots: int,
                 bounds, device="cuda"):
        set_f32_policy()
        self.device = torch.device(device)
        self.cfg = cfg
        self.bounds = tuple(float(b) for b in bounds)
        self._n = n_slots
        self._p = local_slots
        self.scale_factors = torch.tensor(cfg.orb.level_scales(),
                                          dtype=torch.float32,
                                          device=self.device)
        self.inv_sigma2 = 1.0 / self.scale_factors ** 2
        self.log_sf = float(math.log(cfg.orb.scale_factor))

    # ---- device programs --------------------------------------------------

    def _pose_opt(self, Tcw, Xw, obs, inv_sigma2, ok, ur):
        cam = self.cfg.camera
        return pose_optimization(
            Tcw, Xw, obs, inv_sigma2, ok, cam.fx, cam.fy, cam.cx, cam.cy,
            obs_ur=torch.where(ok, ur, torch.full_like(ur, -1.0)), bf=cam.bf)

    def motion_core(self, proj, ok, pos_last, packed_last, packed_cur,
                    Tcw_pred, th):
        _, ang_last, oct_last, _, desc_last, _ = unpack(packed_last)
        cur_xy, cur_ang, cur_oct, cur_valid, cur_desc, cur_ur = unpack(packed_cur)
        D = distance_matrix(desc_last, cur_desc)
        radius = th * self.scale_factors[oct_last]
        n_cur = cur_xy.shape[0]
        dx = (cur_xy[None, :, 0] - proj[:, None, 0]).abs()
        dy = (cur_xy[None, :, 1] - proj[:, None, 1]).abs()
        band = ((cur_oct[None, :] >= oct_last[:, None] - 1)
                & (cur_oct[None, :] <= oct_last[:, None] + 1))
        base = ok[:, None] & cur_valid[None, :] & band

        def masked_match(r):
            in_win = (dx <= r[:, None]) & (dy <= r[:, None])
            best_j, best_d, _ = matching._masked_best2(D, base & in_win)
            m = (best_d <= matching.TH_HIGH) & ok
            m = matching._dedupe_keep_best(best_j, best_d, m, n_cur)
            m = matching.rotation_consistency(ang_last, cur_ang[best_j], m)
            return best_j, m

        j1, m1 = masked_match(radius)
        j2, m2 = masked_match(2.0 * radius)
        use_wide = m1.sum() < 20
        best_j = torch.where(use_wide, j2, j1)
        matched = torch.where(use_wide, m2, m1)
        T_opt, inlier, n_in = self._pose_opt(
            Tcw_pred, pos_last, cur_xy[best_j],
            self.inv_sigma2[cur_oct[best_j]], matched, cur_ur[best_j])
        return T_opt, best_j, matched, inlier, n_in, cur_valid

    def localmap_core(self, pos, normal, mind, maxd, lm_desc, lm_valid,
                      Xw_pre, ok_pre, packed_cur, already, Tcw):
        cam = self.cfg.camera
        cur_xy, _, cur_oct, cur_valid, cur_desc, cur_ur = unpack(packed_cur)
        b = self.bounds
        fr = frustum_ops.frustum_check(
            pos, normal, mind, maxd, lm_valid, Tcw,
            cam.fx, cam.fy, cam.cx, cam.cy, b[0], b[1], b[2], b[3],
            self.log_sf, self.cfg.orb.n_levels)
        r = torch.where(fr["view_cos"] > 0.998, 2.5, 4.0)
        radius = r * self.scale_factors[fr["pred_level"]]
        res = matching.search_by_projection_local_map(
            fr["proj_xy"], radius, fr["pred_level"], fr["visible"], lm_desc,
            cur_xy, cur_desc, cur_valid, cur_oct, already)
        idx2 = res.idx2
        # Attach local points onto their claimed current slots
        # (last-writer-wins under duplicates, like the host loop).
        winner = _scatter_last_wins(Xw_pre.shape[0], idx2, idx2 >= 0,
                                    pos.shape[0])
        has = winner >= 0
        Xw = torch.where(has[:, None], pos[winner.clamp_min(0)], Xw_pre)
        ok = ok_pre | has
        T_opt, inlier, n_in = self._pose_opt(
            Tcw, Xw, cur_xy, self.inv_sigma2[cur_oct], ok, cur_ur)
        return T_opt, idx2, fr["visible"], inlier, n_in

    def _fused(self, host_in, packed_last, packed_cur, lm_pos, lm_normal,
               lm_mind, lm_maxd, lm_desc, lm_valid):
        """Motion stage + local-map stage in one device pass. host_in packs
        the per-frame host inputs into ONE f32[N,8] upload: 0:2 proj, 2 ok,
        3:6 pos_last, 6 last2local, 7 rows 0..15 = Tcw_pred and row 17 = th."""
        dev = host_in.device
        proj = host_in[:, 0:2]
        ok = host_in[:, 2] > 0.5
        pos_last = host_in[:, 3:6]
        last2local = host_in[:, 6].to(torch.int64)
        Tcw_pred = host_in[:16, 7].reshape(4, 4)
        th = host_in[17, 7]
        n = pos_last.shape[0]
        P = lm_pos.shape[0]
        T1, best_j, matched, inlier1, n_in1, cur_valid = self.motion_core(
            proj, ok, pos_last, packed_last, packed_cur, Tcw_pred, th)
        good = matched & inlier1
        # good best_j are unique (_dedupe_keep_best); the other rows are
        # routed out of range and dropped.
        safe_j = torch.where(good, best_j, torch.full_like(best_j, n))
        Xw_pre = _drop_set(n, safe_j, pos_last, 0.0, dev)
        ok_pre = _drop_set(n, safe_j, torch.ones(n, dtype=torch.bool,
                                                 device=dev), False, dev)
        ll = torch.where(good & (last2local >= 0), last2local,
                         torch.full_like(last2local, P))
        already_local = _drop_set(P, ll, torch.ones(n, dtype=torch.bool,
                                                    device=dev), False, dev)
        T2, idx2, visible, inlier2, n_in2 = self.localmap_core(
            lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc,
            lm_valid & ~already_local, Xw_pre, ok_pre, packed_cur, ok_pre, T1)
        f = torch.float32
        return torch.cat([
            T2.reshape(-1),
            best_j.to(f), matched.to(f), inlier1.to(f),
            idx2.to(f), visible.to(f), already_local.to(f), inlier2.to(f),
            torch.stack([n_in1.to(f), matched.sum().to(f),
                         cur_valid.sum().to(f), n_in2.to(f)]),
        ])

    # ---- host wrappers: one upload, one fetch, numpy outputs ---------------

    def _tensor(self, a):
        return to_device(a, self.device)

    def motion_step(self, proj, ok, pos_last, packed_last, packed_cur,
                    Tcw_pred, th=15.0):
        """Motion-model search + pose LM (reference TrackWithMotionModel).
        Numpy inputs except the packed frames. Returns (T, best_j, matched,
        inlier, n_in, n_matched, n_valid_cur)."""
        n = len(ok)
        T, best_j, matched, inlier, n_in, cur_valid = self.motion_core(
            self._tensor(proj), self._tensor(ok),
            self._tensor(pos_last), packed_last, packed_cur,
            self._tensor(Tcw_pred), torch.tensor(float(th), device=self.device))
        f = torch.float32
        out = torch.cat([
            T.reshape(-1), best_j.to(f), matched.to(f), inlier.to(f),
            torch.stack([n_in.to(f), matched.sum().to(f),
                         cur_valid.sum().to(f)])]).cpu().numpy()
        return (out[:16].reshape(4, 4).astype(np.float32),
                out[16:16 + n].astype(np.int64),
                out[16 + n:16 + 2 * n] > 0.5,
                out[16 + 2 * n:16 + 3 * n] > 0.5,
                int(out[16 + 3 * n]), int(out[16 + 3 * n + 1]),
                int(out[16 + 3 * n + 2]))

    def localmap_step(self, pos, normal, mind, maxd, lm_desc, lm_valid,
                      Xw_pre, ok_pre, packed_cur, already, Tcw):
        """Local-map search + pose LM (reference TrackLocalMap). Numpy
        inputs except the packed frame; lm_desc is u32[P,8]. Returns (T,
        idx2, visible, inlier, n_in)."""
        p, n = self._p, len(ok_pre)
        block = local_block_from_numpy(pos, normal, mind, maxd, lm_desc,
                                       lm_valid, self.device)
        T, idx2, visible, inlier, n_in = self.localmap_core(
            *block, self._tensor(Xw_pre), self._tensor(ok_pre),
            packed_cur, self._tensor(already), self._tensor(Tcw))
        f = torch.float32
        out = torch.cat([T.reshape(-1), idx2.to(f), visible.to(f),
                         inlier.to(f), n_in.to(f).reshape(1)]).cpu().numpy()
        return (out[:16].reshape(4, 4).astype(np.float32),
                out[16:16 + p].astype(np.int64),
                out[16 + p:16 + 2 * p] > 0.5,
                out[16 + 2 * p:16 + 2 * p + n] > 0.5,
                int(out[16 + 2 * p + n]))

    def fused_step(self, proj, ok, pos_last, packed_last, packed_cur,
                   Tcw_pred, lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc,
                   lm_valid, last2local, th=15.0):
        """Motion + local-map tracking stages fused. Numpy inputs except the
        packed frames (device tensors); lm_desc is u32[P,8]. Returns the JAX
        package's tuple (T2, best_j, matched, inlier1, idx2, visible,
        already, inlier2, n_in1, n_matched, n_valid_cur, n_in2)."""
        n = len(ok)
        if n != self._n or len(lm_valid) != self._p:
            raise ValueError(f"fused_step built for {self._n} slots and a "
                             f"{self._p}-point block, got {n} and "
                             f"{len(lm_valid)}")
        host_in = np.zeros((n, 8), np.float32)
        host_in[:, 0:2] = proj
        host_in[:, 2] = ok
        host_in[:, 3:6] = pos_last
        host_in[:, 6] = last2local
        host_in[:16, 7] = np.asarray(Tcw_pred, np.float32).ravel()
        host_in[17, 7] = th
        block = local_block_from_numpy(lm_pos, lm_normal, lm_mind, lm_maxd,
                                       lm_desc, lm_valid, self.device)
        out = self._fused(torch.from_numpy(host_in).to(self.device),
                          packed_last, packed_cur, *block).cpu().numpy()
        p = self._p
        o = 16
        T2 = out[:16].reshape(4, 4).astype(np.float32)
        best_j = out[o:o + n].astype(np.int64); o += n
        matched = out[o:o + n] > 0.5; o += n
        inlier1 = out[o:o + n] > 0.5; o += n
        idx2 = out[o:o + p].astype(np.int64); o += p
        visible = out[o:o + p] > 0.5; o += p
        already = out[o:o + p] > 0.5; o += p
        inlier2 = out[o:o + n] > 0.5; o += n
        n_in1 = int(out[o]); n_matched = int(out[o + 1])
        n_valid_cur = int(out[o + 2]); n_in2 = int(out[o + 3])
        return (T2, best_j, matched, inlier1, idx2, visible, already,
                inlier2, n_in1, n_matched, n_valid_cur, n_in2)
