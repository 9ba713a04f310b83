"""Fused per-frame tracking programs on the device.

Port of orb_slam_system_tpu/models/track_device.py (motion_step,
localmap_step, fused_step and the pipelined chain_step). The tracker runs
fused_step on a steady frame and falls back to motion_step (then a
reference-keyframe match) and localmap_step when the fused result is weak:

  * motion stage: motion-model projection search (narrow and widened window
    from ONE distance matrix, the reference's `if(nmatches<20) search again
    with 2*th`) + the 4x10 LM pose optimization;
  * local-map stage: frustum check over the local-map block, projection
    search with the view-cos-dependent radius, association scatter, and the
    final pose optimization (reference TrackLocalMap).

Each host wrapper uploads its per-frame inputs once and fetches ONE packed
f32 result, with the JAX package's argument lists and outputs.

chain_step is the pipelined mode's step: the pose state (T_prev, T_last)
and the association of the last frame's slots into the local-map block
stay on the device from one step to the next, so the host enqueues frame
k+1's step before it has read frame k's result. The step reads nothing
back to the host (no .item(), .cpu(), bool() of a tensor, boolean
indexing or blocking upload); ChainFetch copies its packed result into a
pinned host buffer behind it, and the host waits on that copy's CUDA event
alone, `depth` frames later (models/system.py, _track_pipelined).
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
from orb_slam_system_tpu_torch.utils import lie
from orb_slam_system_tpu_torch.utils.interop import (local_block_from_numpy,
                                                     to_device)
from orb_slam_system_tpu_torch.utils.metrics import fetch, span
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
    7 valid, 8:16 descriptor words, 16 u_right (a stereo or RGB-D frame's
    18 columns; -1 for a monocular frame's 16), so stereo edges reach the
    pose LM."""
    xy = packed[:, 2:4]
    ang = packed[:, 5]
    octv = packed[:, 6].to(torch.int64)
    valid = packed[:, 7] > 0.5
    desc = packed[:, 8:16].contiguous().view(torch.int32)
    if packed.shape[1] > 16:
        ur = packed[:, 16]
    else:
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
        """Every pose LM of tracking (the span track.pose_lm)."""
        cam = self.cfg.camera
        with span("track.pose_lm"):
            return pose_optimization(
                Tcw, Xw, obs, inv_sigma2, ok, cam.fx, cam.fy, cam.cx, cam.cy,
                obs_ur=torch.where(ok, ur, torch.full_like(ur, -1.0)),
                bf=cam.bf)

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

    def _chain(self, T_prev, T_last, assoc_in, lm_remap, packed_last,
               packed_cur, lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc,
               lm_valid, th):
        """The device-state step (JAX track_device.py chain_step): from
        (T_prev, T_last, assoc) it derives velocity = T_last T_prev^-1,
        Tcw_pred = velocity T_last, pos_last = lm_pos[assoc] and the
        projection on the device, runs the motion and local-map cores, and
        carries the association to the current frame in the host
        bookkeeping's order: motion matches attach, local-map matches
        overwrite (last writer wins), final outliers detach.

        lm_remap i64[P] maps the previous step's block rows to this block's
        (-1: the point left the block). Both poses are projected back onto
        SE(3) first: the state loops device to device, and without the
        projection the rotation's f32 rounding compounds through the
        transpose inverse (det(R) fell to 0.59 within ~12 frames in the JAX
        package). Returns (T_last projected, T_cur, assoc_out i64[N],
        packed_out f32[16 + N + 2P + 6]): T_cur, assoc_out, visible and
        already-local per block row, then n_in1, n_matched, n_valid_cur,
        n_in2 and, for an 18-column frame, the close-point counts of the
        keyframe rule (tracked, not tracked; 0 for a monocular frame)."""
        cam = self.cfg.camera
        dev = assoc_in.device
        n = assoc_in.shape[0]
        P = lm_pos.shape[0]
        minus1 = torch.full_like(assoc_in, -1)
        assoc = torch.where(assoc_in >= 0, lm_remap[assoc_in.clamp(0, P - 1)],
                            minus1)
        T_prev = lie.se3_project(T_prev)
        T_last = lie.se3_project(T_last)
        velocity = T_last @ lie.se3_inv(T_prev)
        Tcw_pred = velocity @ T_last
        pos_last = lm_pos[assoc.clamp(0, P - 1)]
        Xc = pos_last @ Tcw_pred[:3, :3].T + Tcw_pred[:3, 3]
        z = Xc[:, 2]
        zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        proj = torch.stack([cam.fx * Xc[:, 0] / zs + cam.cx,
                            cam.fy * Xc[:, 1] / zs + cam.cy], dim=1)
        ok = (assoc >= 0) & (z > 0)
        T1, best_j, matched, inlier1, n_in1, cur_valid = self.motion_core(
            proj, ok, pos_last, packed_last, packed_cur, Tcw_pred, th)
        good = matched & inlier1
        # As in _fused: the good best_j are unique, the rest dropped.
        safe_j = torch.where(good, best_j, torch.full_like(best_j, n))
        Xw_pre = _drop_set(n, safe_j, pos_last, 0.0, dev)
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        ok_pre = _drop_set(n, safe_j, ones, False, dev)
        ll = torch.where(good & (assoc >= 0), assoc, torch.full_like(assoc, P))
        already_local = _drop_set(P, ll, ones, False, dev)
        T2, idx2, visible, inlier2, n_in2 = self.localmap_core(
            lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc,
            lm_valid & ~already_local, Xw_pre, ok_pre, packed_cur, ok_pre, T1)
        win1 = _scatter_last_wins(n, best_j, good, n)
        a1 = torch.where(win1 >= 0, assoc[win1.clamp_min(0)], minus1)
        win2 = _scatter_last_wins(n, idx2, idx2 >= 0, P)
        assoc_out = torch.where(win2 >= 0, win2, a1)
        assoc_out = torch.where(inlier2, assoc_out, minus1)
        f = torch.float32
        if packed_cur.shape[1] >= 18:
            depth = packed_cur[:, 17]
            close = cur_valid & (depth > 0.0) & (depth < float(self.cfg.th_depth))
            tracked = assoc_out >= 0
            n_close = torch.stack([(close & tracked).sum().to(f),
                                   (close & ~tracked).sum().to(f)])
        else:
            n_close = torch.zeros(2, dtype=f, device=dev)
        packed_out = torch.cat([
            T2.reshape(-1), assoc_out.to(f), visible.to(f), already_local.to(f),
            torch.stack([n_in1.to(f), matched.sum().to(f),
                         cur_valid.sum().to(f), n_in2.to(f)]),
            n_close])
        return T_last, T2, assoc_out, packed_out

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
        out = fetch(torch.cat([
            T.reshape(-1), best_j.to(f), matched.to(f), inlier.to(f),
            torch.stack([n_in.to(f), matched.sum().to(f),
                         cur_valid.sum().to(f)])]), "track")
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
        out = fetch(torch.cat([T.reshape(-1), idx2.to(f), visible.to(f),
                               inlier.to(f), n_in.to(f).reshape(1)]), "track")
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
        out = fetch(self._fused(torch.from_numpy(host_in).to(self.device),
                                packed_last, packed_cur, *block), "track")
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

    def chain_step(self, T_prev, T_last, assoc, lm_remap, packed_last,
                   packed_cur, lm_block, th=15.0):
        """Enqueue one pipelined step and read nothing back. Every tensor
        argument lives on the device (the state may be a previous step's
        outputs); lm_block is the (pos, normal, mind, maxd, desc, valid)
        block. Returns (T_last_out, T_cur_out, assoc_out, packed_out), all
        on the device: hand packed_out to a ChainFetch and decode it with
        decode_chain_out once the copy landed."""
        return self._chain(T_prev, T_last, assoc, lm_remap, packed_last,
                           packed_cur, *lm_block, float(th))

    @property
    def chain_out_size(self) -> int:
        """Length of a chain step's packed_out."""
        return 16 + self._n + 2 * self._p + 6

    def decode_chain_out(self, out: np.ndarray):
        """A chain step's packed_out, on the host, -> (T_cur f32[4,4], assoc
        i64[N], visible bool[P], already bool[P], n_in1, n_matched,
        n_valid_cur, n_in2, (n_tracked_close, n_nontracked_close)). Every
        array is a copy, so the buffer can be reused."""
        out = np.asarray(out)
        n, p = self._n, self._p
        o = 16
        T2 = out[:16].reshape(4, 4).astype(np.float32)
        assoc = out[o:o + n].astype(np.int64); o += n
        visible = out[o:o + p] > 0.5; o += p
        already = out[o:o + p] > 0.5; o += p
        n_in1 = int(out[o]); n_matched = int(out[o + 1])
        n_valid_cur = int(out[o + 2]); n_in2 = int(out[o + 3])
        close_counts = (int(out[o + 4]), int(out[o + 5]))
        return (T2, assoc, visible, already, n_in1, n_matched, n_valid_cur,
                n_in2, close_counts)


class ChainFetch:
    """Device -> host copies of chain results, one host buffer per slot of
    the pipeline. issue() queues the copy of a step's packed_out behind the
    step on the current stream into the next slot's pinned buffer and
    records a CUDA event after it; wait() blocks on that event alone and
    returns the buffer as numpy. On the CPU the copy is synchronous and
    there is no event.

    A slot is written again `n_slots` issues later. The pipelined mode
    keeps at most depth + 1 steps in flight, so with depth + 1 slots a
    buffer is rewritten only after its frame was decoded (or discarded;
    copies on one stream land in issue order)."""

    def __init__(self, size: int, n_slots: int, device):
        self._cuda = torch.device(device).type == "cuda"
        self._bufs = [torch.empty(size, dtype=torch.float32,
                                  pin_memory=self._cuda)
                      for _ in range(n_slots)]
        self._next = 0

    def issue(self, packed_out: torch.Tensor):
        """Queue the copy of packed_out; returns the ticket wait() takes."""
        buf = self._bufs[self._next]
        self._next = (self._next + 1) % len(self._bufs)
        buf.copy_(packed_out, non_blocking=self._cuda)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        return buf, event

    @staticmethod
    def wait(ticket) -> np.ndarray:
        """Block until the ticket's copy landed; the host buffer as numpy.
        The wait is a fetch (the span track.fetch)."""
        buf, event = ticket
        with span("track.fetch"):
            if event is not None:
                event.synchronize()
            return buf.numpy()
