"""Loop closing: detection, Sim3 computation, loop correction, global BA.

Port of orb_slam_system_tpu/models/loop_closing.py (reference LoopClosing,
src/LoopClosing.cc, with the upstream loop edges and global BA):
  * DetectLoop: BoW candidates from the keyframe database gated by the
    minimum score against the keyframe's covisible neighbours, and
    covisibility-group consistency over three consecutive detections.
  * ComputeSim3: one batched keyframe-keyframe BoW match over all
    candidates (with the unconstrained retry), one batched Sim3 RANSAC over
    those with >= 20 matches, then for each RANSAC survivor in candidate
    order the Sim3-guided mutual re-search, OptimizeSim3 (>= 20 inliers)
    and the >= 40 projected-match gate.
  * CorrectLoop: corrected Sim3s propagated over the current keyframe's
    covisible group, their map points corrected, the loop points fused,
    the covisibility recounted, the essential graph optimized, the loop
    edges added (both end keyframes kept from culling for good), and a
    global BA started.
  * Global BA runs on a side thread in chunks of LM iterations (GBARunner),
    abortable by a newer loop; its result is applied by `poll_gba` on the
    thread that owns the map, with spanning-tree propagation to keyframes
    born during the solve. `sync_gba=True` solves inline instead (tests).

The map stays on the host; each solve takes tensors on the loop closer's
device and returns with one fetch.

The correction contract. A loop correction and a GBA apply rewrite every
keyframe pose at once, so no tracking frame may interleave them:
  * `arena.correction_lock` is the OUTER lock and `arena.lock` the inner
    one: a rewrite releases `arena.lock` (arena.unlocked) before it takes
    `correction_lock`, then holds it for the whole rewrite;
  * `arena.pose_epoch` is bumped at the START and at the END of a loop
    correction (a reader of a half-corrected map sees a stale epoch) and
    once after a GBA apply;
  * the tracker records the epoch a frame's pose derives from
    (Tracker._frame_epoch) and refuses to store a relative pose whose
    epoch moved inside the frame (Tracker.epoch_violations). In this port
    mapping, loop closing and the GBA apply all run on the tracker's own
    thread after the frame, so the count stays 0; the GBA solve alone runs
    on its thread and touches no map state.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import SlamConfig
from orb_slam_system_tpu_torch.mapping.arena import KeyFrameRec, MapArena
from orb_slam_system_tpu_torch.models.local_mapping import _pad_slots
from orb_slam_system_tpu_torch.models.place_recognition import PlaceRecognition
from orb_slam_system_tpu_torch.ops import matching
from orb_slam_system_tpu_torch.solvers import local_ba, pose_graph, sim3
from orb_slam_system_tpu_torch.utils.interop import to_device
from orb_slam_system_tpu_torch.utils.metrics import StageTimer
from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary

CONSISTENCY_TH = 3       # reference src/LoopClosing.cc:17
MIN_KFS_BETWEEN = 10     # reference :61
GBA_DENSE_MAX_CAMS = 48  # dense Schur up to this many keyframes, else CG


def sample_bound(max_matches: int) -> int:
    """The slot bound of the RANSAC sample draw: the JAX package draws its
    sets over its padded match axis, max(64, the next power of two), and
    takes them modulo each pair's valid count. The port's arrays are not
    padded; drawing over the same bound keeps the same samples."""
    return max(64, 1 << (max(max_matches, 1) - 1).bit_length())


class LoopCloser:
    def __init__(self, cfg: SlamConfig, arena: MapArena,
                 place_rec: PlaceRecognition, local_mapper, device="cuda",
                 sync_gba: bool = False):
        self.cfg = cfg
        self.arena = arena
        self.place_rec = place_rec
        self.local_mapper = local_mapper
        self.device = torch.device(device)
        self.last_loop_kf_id = -1
        # (keyframe id, matched keyframe id, Sim3 scale) of the last closure.
        self.last_loop = None
        self.consistent_groups: List[tuple[set, int]] = []
        self.scale_factors = np.asarray(cfg.orb.level_scales(), np.float32)
        self.inv_sigma2 = (1.0 / self.scale_factors ** 2).astype(np.float32)
        self.n_loops_closed = 0
        self.n_gba_applied = 0
        # Funnel of loop attempts: detect calls -> database candidates ->
        # consistent -> sim3 attempts -> each rejection gate -> accepts.
        self.stats = Counter()
        self.stage_ms = StageTimer()
        self.gba = GBARunner(self.stage_ms)
        # The reference solves global BA on a side thread; sync_gba solves
        # it inline, so a run gives the same map every time.
        self.sync_gba = sync_gba

    def _t(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    # ---- the loop thread's body (reference Run :28-41) ---------------------

    def process(self, kf_id: int) -> bool:
        kf = self.arena.kfs.get(kf_id)
        if kf is None or not self.place_rec.ready:
            return False
        with self.stage_ms.stage("detect_loop"):
            candidates = self.detect_loop(kf)
        if not candidates:
            return False
        with self.stage_ms.stage("compute_sim3"):
            ok, matched_kf, Scw, loop_points, cur_matches = self.compute_sim3(
                kf, candidates)
        if not ok:
            return False
        # The correction contract (module docstring): correction_lock
        # outside arena.lock.
        with self.arena.unlocked():
            self.arena.correction_lock.acquire()
        try:
            with self.stage_ms.stage("correct_loop"):
                self.correct_loop(kf, matched_kf, Scw, loop_points,
                                  cur_matches)
        finally:
            self.arena.correction_lock.release()
        self.last_loop = (kf.id, matched_kf.id, float(Scw["s"]))
        self.n_loops_closed += 1
        return True

    # ---- DetectLoop (:55-125) ----------------------------------------------

    def detect_loop(self, kf: KeyFrameRec) -> List[int]:
        if (kf.id < self.last_loop_kf_id + MIN_KFS_BETWEEN
                or self.arena.n_keyframes() < MIN_KFS_BETWEEN
                or kf.bow is None):
            return []
        # Minimum score against the covisible neighbours (:67-74).
        min_score = 1.0
        for nb in kf.covis:
            nb_kf = self.arena.kfs.get(nb)
            if nb_kf is not None and nb_kf.bow is not None:
                min_score = min(min_score, Vocabulary.score(kf.bow, nb_kf.bow))
        candidates = self.place_rec.db.detect_loop_candidates(
            kf.id, kf.bow, min_score, self.arena)
        self.stats["detect_calls"] += 1
        if not candidates:
            self.consistent_groups = []
            return []
        self.stats["db_candidates"] += 1
        # Covisibility consistency over consecutive detections (:84-117).
        enough: List[int] = []
        new_groups: List[tuple[set, int]] = []
        for cand in candidates:
            ckf = self.arena.kfs.get(cand)
            if ckf is None:
                continue
            group = set(ckf.covis) | {cand}
            consistent_for = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    consistent_for = max(consistent_for, prev_count + 1)
            new_groups.append((group, consistent_for))
            if consistent_for >= CONSISTENCY_TH:
                enough.append(cand)
        self.consistent_groups = new_groups
        if enough:
            self.stats["consistent"] += 1
        return enough

    # ---- ComputeSim3 (:127-208) --------------------------------------------

    def compute_sim3(self, kf: KeyFrameRec, candidates: List[int]):
        """Returns (ok, matched keyframe, Scw, loop point ids, cur_matches
        {slot: loop point id}); the first candidate in order that passes
        every gate wins."""
        fail = (False, None, None, None, None)
        ckfs = [(cid, c) for cid in candidates
                if (c := self.arena.kfs.get(cid)) is not None and not c.bad]
        if not ckfs:
            return fail
        st = self.stage_ms
        with st.stage("node_match"):
            match_lists = self._match_keyframes_batch(kf, [c for _, c in ckfs])
        eligible = []
        for (_, ckf), m in zip(ckfs, match_lists):
            self.stats["sim3_attempts"] += 1
            if len(m) < 20:
                self.stats["rej_bow_lt20"] += 1
                continue
            rows1 = np.asarray([a for a, _ in m])
            rows2 = np.asarray([b for _, b in m])
            P1, ok1 = self._cam_points(kf, rows1)
            P2, ok2 = self._cam_points(ckf, rows2)
            ok = ok1 & ok2
            if ok.sum() < 20:
                continue
            eligible.append((ckf, rows1, rows2, P1, P2, ok))
        if not eligible:
            return fail
        cam = self.cfg.camera
        C = len(eligible)
        N = max(len(e[1]) for e in eligible)
        P1b = np.zeros((C, N, 3), np.float32)
        P2b = np.zeros((C, N, 3), np.float32)
        uv1b = np.zeros((C, N, 2), np.float32)
        uv2b = np.zeros((C, N, 2), np.float32)
        m1b = np.ones((C, N), np.float32)
        m2b = np.ones((C, N), np.float32)
        okb = np.zeros((C, N), bool)
        sigma2 = 1.0 / self.inv_sigma2
        for k, (ckf, rows1, rows2, P1, P2, ok) in enumerate(eligible):
            n = len(rows1)
            P1b[k, :n], P2b[k, :n] = P1, P2
            uv1b[k, :n] = kf.feats.xy_und[rows1]
            uv2b[k, :n] = ckf.feats.xy_und[rows2]
            m1b[k, :n] = 9.21 * sigma2[kf.feats.octave[rows1]]
            m2b[k, :n] = 9.21 * sigma2[ckf.feats.octave[rows2]]
            okb[k, :n] = ok
        sets = sim3.make_sim3_sample_sets(sample_bound(N), 300, 0)
        t = self._t
        with st.stage("sim3_ransac_batch"):
            out = sim3.sim3_ransac_batch(
                t(P1b), t(P2b), t(uv1b), t(uv2b), t(m1b), t(m2b), t(okb),
                t(sets), cam.fx, cam.fy, cam.cx, cam.cy).cpu().numpy()
        for k, (ckf, rows1, rows2, P1, P2, ok) in enumerate(eligible):
            if not out[k, 0] > 0.5:
                self.stats["rej_ransac"] += 1
                continue
            s12 = out[k, 1]
            R12 = out[k, 2:11].reshape(3, 3)
            t12 = out[k, 11:14]
            inl = out[k, 14:14 + len(rows1)] > 0.5
            # The Sim3-guided mutual re-search tops up the RANSAC inliers
            # (upstream ComputeSim3 :184-190 + ORBmatcher::SearchBySim3).
            matches12 = {int(rows1[i]): int(rows2[i]) for i in np.nonzero(inl)[0]}
            with st.stage("search_by_sim3"):
                matches12.update(self._search_by_sim3(
                    kf, ckf, float(s12), R12, t12, matches12, th=7.5))
            if len(matches12) < 20:
                self.stats["rej_sim3_search_lt20"] += 1
                continue
            rows1 = np.asarray(sorted(matches12), np.int64)
            rows2 = np.asarray([matches12[i] for i in rows1], np.int64)
            P1, ok1 = self._cam_points(kf, rows1)
            P2, ok2 = self._cam_points(ckf, rows2)
            # OptimizeSim3 with the >= 20 inlier gate (:195-206).
            with st.stage("optimize_sim3"):
                n_in, s_f, R_f, t_f, inl_f = pose_graph.optimize_sim3(
                    t(np.float32(s12)), t(R12), t(t12), t(P1), t(P2),
                    t(kf.feats.xy_und[rows1]), t(ckf.feats.xy_und[rows2]),
                    t(self.inv_sigma2[kf.feats.octave[rows1]]),
                    t(self.inv_sigma2[ckf.feats.octave[rows2]]),
                    t(ok1 & ok2), cam.fx, cam.fy, cam.cx, cam.cy)
                res = torch.cat([n_in.to(s_f.dtype)[None], s_f[None],
                                 R_f.reshape(9), t_f,
                                 inl_f.to(s_f.dtype)]).cpu().numpy()
            if int(res[0]) < 20:
                self.stats["rej_opt_lt20"] += 1
                continue
            s_f = float(res[1])
            R_f = res[2:11].reshape(3, 3)
            t_f = res[11:14]
            inl_f = res[14:] > 0.5
            # Scw = S12 T2w: world -> current keyframe's camera.
            T2w = ckf.Tcw
            Scw = {"s": s_f,
                   "R": (R_f @ T2w[:3, :3]).astype(np.float32),
                   "t": (s_f * (R_f @ T2w[:3, 3]) + t_f).astype(np.float32)}
            # Loop map points: the candidate's and its neighbours' (:210-222).
            loop_points = self._collect_loop_points(ckf)
            cur_matches = {int(rows1[i]): int(ckf.mp_ids[rows2[i]])
                           for i in np.nonzero(inl_f)[0]
                           if ckf.mp_ids[rows2[i]] >= 0}
            # All loop points projected into the current keyframe with Scw;
            # fewer than 40 matches in all aborts the attempt (upstream
            # ComputeSim3 :192-206).
            self._project_loop_points(kf, Scw, loop_points, cur_matches,
                                      th=10.0)
            if len(cur_matches) < 40:
                self.stats["rej_project_lt40"] += 1
                return fail
            self.stats["accept"] += 1
            return True, ckf, Scw, loop_points, cur_matches
        return fail

    def _match_keyframes_batch(self, kf1: KeyFrameRec, ckfs):
        """SearchByBoW(KF, KF) against every candidate in one call
        (matching.search_by_node_id_retry_batch) over the features with map
        points. Returns one [(slot1, slot2), ...] list per candidate."""
        has1 = (kf1.mp_ids >= 0) & kf1.feats.valid
        n1 = (kf1.node_ids if kf1.node_ids is not None
              else np.zeros(kf1.feats.n_slots, np.int32))
        n2max = max(k.feats.n_slots for k in ckfs)

        def stack(f):
            return np.stack([_pad_slots(np.asarray(f(k)), n2max) for k in ckfs])

        has2 = stack(lambda k: (k.mp_ids >= 0) & k.feats.valid)
        node2 = stack(lambda k: (k.node_ids if k.node_ids is not None
                                 else np.zeros(k.feats.n_slots, np.int32)))
        t = self._t
        idx2_all = matching.search_by_node_id_retry_batch(
            t(kf1.feats.desc), t(has1), t(kf1.feats.angle),
            t(np.where(has1, n1, -1)),
            t(stack(lambda k: k.feats.desc)), t(has2),
            t(stack(lambda k: k.feats.angle)),
            t(np.where(has2, node2, -1))).cpu().numpy()
        return [[(int(i), int(row[i])) for i in np.nonzero(row >= 0)[0]]
                for row in idx2_all]

    def _slot_points(self, kf: KeyFrameRec, exclude=frozenset()):
        """Per-slot map-point arrays (descriptor, world position,
        scale-invariance band, validity) from the arena's columnar point
        snapshot."""
        N = kf.feats.n_slots
        desc = np.zeros((N, 8), np.uint32)
        pos = np.zeros((N, 3), np.float32)
        mind = np.zeros(N, np.float32)
        maxd = np.ones(N, np.float32)
        rows, ok = self.arena.lookup_points(kf.mp_ids)
        if exclude:
            ok = ok.copy()
            ok[np.fromiter(exclude, np.int64, len(exclude))] = False
        if ok.any():
            (_, c_pos, c_desc, c_mind, c_maxd,
             _n_obs, _normal) = self.arena.point_columns()
            r = rows[ok]
            desc[ok] = c_desc[r]
            pos[ok] = c_pos[r]
            mind[ok] = 0.8 * c_mind[r]
            maxd[ok] = np.maximum(1.2 * c_maxd[r], 1e-6)
        return desc, pos, mind, maxd, ok

    def _sim3_guided_geometry(self, pos, mind, maxd, ok, sR, t, th):
        """World points into a camera through the Sim3 (sR, t): (proj
        f32[N,2], radius f32[N], predicted level i32[N], ok bool[N])."""
        cam = self.cfg.camera
        Xc = pos @ sR.T + t
        z = Xc[:, 2]
        good = ok & (z > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = Xc[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9,
                                        z[:, None])
        proj = (proj * [cam.fx, cam.fy] + [cam.cx, cam.cy]).astype(np.float32)
        good &= ((proj[:, 0] >= 0) & (proj[:, 0] < cam.width)
                 & (proj[:, 1] >= 0) & (proj[:, 1] < cam.height))
        dist = np.linalg.norm(Xc, axis=1)
        good &= (dist >= mind) & (dist <= maxd)
        with np.errstate(divide="ignore", invalid="ignore"):
            lvl = np.ceil(np.log(np.maximum(maxd / 1.2, 1e-9)
                                 / np.maximum(dist, 1e-9))
                          / np.log(self.cfg.orb.scale_factor))
        lvl = np.clip(np.nan_to_num(lvl, nan=0.0), 0,
                      self.cfg.orb.n_levels - 1).astype(np.int32)
        radius = (th * self.scale_factors[lvl]).astype(np.float32)
        return proj, radius, lvl, good

    def _search_by_sim3(self, kf1: KeyFrameRec, kf2: KeyFrameRec, s12: float,
                        R12, t12, matches12: Dict[int, int],
                        th: float = 7.5) -> Dict[int, int]:
        """Mutual Sim3-guided re-search (upstream ORBmatcher::SearchBySim3);
        S12 maps camera 2 into camera 1. Returns the NEW {slot1: slot2}
        pairs, none already in matches12."""
        d1, p1w, mind1, maxd1, ok1 = self._slot_points(
            kf1, exclude=set(matches12))
        d2, p2w, mind2, maxd2, ok2 = self._slot_points(
            kf2, exclude=set(matches12.values()))
        if ok1.sum() == 0 or ok2.sum() == 0:
            return {}
        sR21 = (1.0 / s12) * R12.T
        t21 = -(sR21 @ t12)
        sR12 = s12 * R12
        # World -> camera 1 (SE3) -> camera 2 (S21) for KF1's points, and
        # world -> camera 2 -> camera 1 (S12) for KF2's.
        R1w, t1w = kf1.Tcw[:3, :3], kf1.Tcw[:3, 3]
        R2w, t2w = kf2.Tcw[:3, :3], kf2.Tcw[:3, 3]
        g1 = self._sim3_guided_geometry(p1w, mind1, maxd1, ok1, sR21 @ R1w,
                                        sR21 @ t1w + t21, th)
        g2 = self._sim3_guided_geometry(p2w, mind2, maxd2, ok2, sR12 @ R2w,
                                        sR12 @ t2w + t12, th)
        t = self._t
        f1, f2 = kf1.feats, kf2.feats
        idx2 = matching.search_by_sim3(
            t(d1), *(t(a) for a in g1), t(d2), *(t(a) for a in g2),
            t(f1.desc), t(f1.xy_und), t(f1.valid), t(f1.octave),
            t(f2.desc), t(f2.xy_und), t(f2.valid), t(f2.octave)).cpu().numpy()
        return {int(i): int(j) for i, j in enumerate(idx2) if j >= 0}

    def _project_loop_points(self, kf: KeyFrameRec, Scw: dict,
                             loop_points: List[int],
                             cur_matches: Dict[int, int], th: float = 10.0):
        """Loop map points projected into the current keyframe with Scw
        claim its unmatched slots (upstream SearchByProjection(KF, Scw, ...),
        TH_LOW, radius th * scale)."""
        already_pts = set(cur_matches.values())
        mps = self.arena.mps
        ids = [m for m in loop_points
               if m not in already_pts and m in mps and not mps[m].bad]
        if not ids:
            return
        pos = np.stack([mps[m].pos for m in ids])
        desc = np.stack([mps[m].desc for m in ids])
        mind = np.asarray([0.8 * mps[m].min_dist for m in ids], np.float32)
        maxd = np.asarray([max(1.2 * mps[m].max_dist, 1e-6) for m in ids],
                          np.float32)
        proj, radius, lvl, good = self._sim3_guided_geometry(
            pos, mind, maxd, np.ones(len(ids), bool), Scw["R"],
            Scw["t"] / Scw["s"], th)
        already = np.zeros(kf.feats.n_slots, bool)
        already[list(cur_matches)] = True
        t = self._t
        f = kf.feats
        idx2 = matching.search_by_projection_set(
            t(proj), t(radius), t(lvl), t(good), t(desc), t(f.xy_und),
            t(f.desc), t(f.valid), t(f.octave), t(already),
            max_dist=matching.TH_LOW).idx2.cpu().numpy()
        for k in np.nonzero(idx2 >= 0)[0]:
            slot = int(idx2[k])
            if slot not in cur_matches:
                cur_matches[slot] = ids[k]

    def _cam_points(self, kf: KeyFrameRec, rows):
        P = np.zeros((len(rows), 3), np.float32)
        ok = np.zeros(len(rows), bool)
        for k, r in enumerate(rows):
            mid = int(kf.mp_ids[r])
            if mid >= 0:
                mp = self.arena.mps.get(mid)
                if mp is not None and not mp.bad:
                    P[k] = kf.Tcw[:3, :3] @ mp.pos + kf.Tcw[:3, 3]
                    ok[k] = True
        return P, ok

    def _collect_loop_points(self, ckf: KeyFrameRec) -> List[int]:
        ids = set()
        for kf_id in [ckf.id] + self.arena.covisible_ordered(ckf):
            kf = self.arena.kfs.get(kf_id)
            if kf is None:
                continue
            for mid in kf.mp_ids:
                if mid >= 0 and int(mid) in self.arena.mps:
                    ids.add(int(mid))
        return list(ids)

    # ---- CorrectLoop (:225-300) --------------------------------------------

    def correct_loop(self, kf: KeyFrameRec, matched_kf: KeyFrameRec,
                     Scw: dict, loop_points: List[int],
                     cur_matches: Dict[int, int]):
        arena = self.arena
        arena.pose_epoch += 1       # start of the rewrite (module docstring)
        # 1. Corrected Sim3 of the current keyframe and its covisible group
        #    (:246-270): S_i = T_ic Scw; T_ic is SE3, so t = R_ic t_cw + t_ic.
        Twc = np.linalg.inv(kf.Tcw)
        corrected: Dict[int, dict] = {}
        non_corrected: Dict[int, np.ndarray] = {}
        for g_id in [kf.id] + arena.covisible_ordered(kf):
            gkf = arena.kfs.get(g_id)
            if gkf is None:
                continue
            non_corrected[g_id] = gkf.Tcw.copy()
            Tic = gkf.Tcw @ Twc
            corrected[g_id] = {"s": Scw["s"], "R": Tic[:3, :3] @ Scw["R"],
                               "t": Tic[:3, :3] @ Scw["t"] + Tic[:3, 3]}
        # 2. The group's map points and poses (:253-290).
        moved: set[int] = set()
        moved_recs = []
        for g_id, S_n in corrected.items():
            gkf = arena.kfs[g_id]
            T_old = non_corrected[g_id]
            for mid in gkf.mp_ids:
                if mid < 0 or int(mid) in moved:
                    continue
                mp = arena.mps.get(int(mid))
                if mp is None or mp.bad:
                    continue
                # p_corrected = S_corr^-1(T_old p).
                pc = T_old[:3, :3] @ mp.pos + T_old[:3, 3]
                arena.set_point_pos(
                    mp, (1.0 / S_n["s"]) * (S_n["R"].T @ (pc - S_n["t"])))
                moved.add(int(mid))
                moved_recs.append(mp)
            gkf.Tcw = np.eye(4, dtype=np.float32)
            gkf.Tcw[:3, :3] = S_n["R"]
            gkf.Tcw[:3, 3] = S_n["t"] / S_n["s"]
            arena.update_connections(gkf)
        arena.update_normals_many(moved_recs, self.scale_factors)
        # 3. The matched loop points into the current keyframe (:273-279).
        for feat_idx, loop_mid in cur_matches.items():
            cur_mid = int(kf.mp_ids[feat_idx])
            lp = arena.mps.get(loop_mid)
            if lp is None or lp.bad:
                continue
            if cur_mid >= 0 and cur_mid != loop_mid:
                cur_mp = arena.mps.get(cur_mid)
                if cur_mp is not None and not cur_mp.bad:
                    arena.replace_point(cur_mp, lp)
            else:
                arena.add_observation(lp, kf, feat_idx)
                arena.compute_distinctive_descriptor(lp)
        # 4. SearchAndFuse: the loop points into every corrected keyframe.
        self._search_and_fuse(corrected, loop_points)
        # 5. Recount the group's connections after the fusion (upstream
        #    CorrectLoop :283-296); the NEW cross-loop links (minus prior
        #    neighbours and the group) become loop constraints of the
        #    essential graph.
        prev_covis = {g: set(arena.kfs[g].covis)
                      for g in corrected if g in arena.kfs}
        loop_connections: Dict[int, set] = {}
        for g_id in corrected:
            gkf = arena.kfs.get(g_id)
            if gkf is None:
                continue
            arena.update_connections(gkf)
            new = set(gkf.covis) - prev_covis.get(g_id, set()) - set(corrected)
            if new:
                loop_connections[g_id] = new
        with self.stage_ms.stage("essential_graph"):
            self._optimize_essential_graph(kf, matched_kf, corrected,
                                           non_corrected, loop_connections)
        # 6. The loop edge; both ends are kept from culling for good
        #    (upstream AddLoopEdge sets mbNotErase, src/KeyFrame.cc:398-409),
        #    or a later loop's essential graph would dangle.
        kf.loop_edges.add(matched_kf.id)
        matched_kf.loop_edges.add(kf.id)
        kf.not_erase = True
        matched_kf.not_erase = True
        self.last_loop_kf_id = kf.id
        arena.pose_epoch += 1       # end of the rewrite
        # 7. Global BA (upstream RunGlobalBundleAdjustment :340-410).
        self._start_global_ba()

    def _search_and_fuse(self, corrected: Dict[int, dict], loop_points):
        """SearchAndFuse (reference :302-317): the loop points projected
        into every corrected keyframe in one batched search; they replace
        current-map duplicates unconditionally (Fuse(KF, Scw, ...))."""
        ids = [m for m in loop_points if m in self.arena.mps]
        jobs = [(self.arena.kfs[g_id], ids) for g_id in corrected
                if g_id in self.arena.kfs]
        if ids and jobs:
            self.local_mapper._fuse_jobs(jobs, radius_th=4.0,
                                         replace_existing=True)

    def _optimize_essential_graph(self, kf, matched_kf, corrected,
                                  non_corrected, loop_connections):
        """Build and solve the essential graph (reference
        Optimizer::OptimizeEssentialGraph :762-1025): the new loop
        connections first, then spanning-tree edges, existing loop edges
        and covisibility edges >= 100; the matched keyframe is fixed."""
        arena = self.arena
        kf_ids = sorted(arena.kfs)
        index = {k: i for i, k in enumerate(kf_ids)}
        K = len(kf_ids)
        # Vertices: the corrected group at its full corrected Sim3, the rest
        # at their SE3 pose with scale 1 (reference :820-860).
        R0 = np.zeros((K, 3, 3), np.float32)
        t0 = np.zeros((K, 3), np.float32)
        s0 = np.ones(K, np.float32)
        for k_id in kf_ids:
            i = index[k_id]
            if k_id in corrected:
                S = corrected[k_id]
                R0[i], t0[i], s0[i] = S["R"], S["t"], S["s"]
            else:
                T = arena.kfs[k_id].Tcw
                R0[i], t0[i] = T[:3, :3], T[:3, 3]
        init_sim3 = [(float(s0[i]), R0[i].copy(), t0[i].copy())
                     for i in range(K)]
        fixed = np.zeros(K, bool)
        fixed[index[matched_kf.id]] = True
        e_i, e_j, e_R, e_t, e_s = [], [], [], [], []
        added = set()

        def sim3_of(T):
            return 1.0, T[:3, :3], T[:3, 3]

        def add_edge(i_id, j_id, Si, Sj):
            """Measurement Sji = S_j S_i^-1 of (s, R, t) triples."""
            key = (min(i_id, j_id), max(i_id, j_id))
            if key in added or i_id not in index or j_id not in index:
                return
            added.add(key)
            si, Ri, ti = Si
            sj, Rj, tj = Sj
            sji = sj / si
            Rji = Rj @ Ri.T
            e_i.append(index[i_id])
            e_j.append(index[j_id])
            e_R.append(Rji)
            e_t.append(tj - sji * (Rji @ ti))
            e_s.append(sji)

        # Insertion order matters (upstream :862-884 inserts the loop
        # connections first and skips duplicates among the tree and covis
        # edges): after the recount, (current, matched) is typically a
        # >= 100 covisibility pair, and its covis edge, measured from the
        # drifted poses, would otherwise displace the loop constraint.
        def vertex_pose(x_id):
            S = corrected.get(x_id)
            if S is not None:
                return S["s"], S["R"], S["t"]
            return sim3_of(arena.kfs[x_id].Tcw)

        add_edge(kf.id, matched_kf.id, vertex_pose(kf.id),
                 sim3_of(non_corrected.get(matched_kf.id,
                                           arena.kfs[matched_kf.id].Tcw)))
        for g_id, nbs in loop_connections.items():
            gkf = arena.kfs.get(g_id)
            if gkf is None:
                continue
            for nb in nbs:
                if nb not in arena.kfs:
                    continue
                # Weight filter as upstream (minFeat = 100), except the main
                # loop pair.
                if (gkf.covis.get(nb, 0) < 100
                        and not (g_id == kf.id and nb == matched_kf.id)):
                    continue
                add_edge(g_id, nb, vertex_pose(g_id), vertex_pose(nb))

        # Edges inside the corrected group are measured at the
        # pre-correction poses (reference NonCorrectedSim3).
        def pose_of(x_id):
            return sim3_of(non_corrected.get(x_id, arena.kfs[x_id].Tcw))

        for k_id in kf_ids:
            k_kf = arena.kfs[k_id]
            if k_kf.parent >= 0 and k_kf.parent in arena.kfs:
                add_edge(k_id, k_kf.parent, pose_of(k_id), pose_of(k_kf.parent))
            for le in k_kf.loop_edges:
                if le in arena.kfs:
                    add_edge(k_id, le, pose_of(k_id), pose_of(le))
            for nb, w in k_kf.covis.items():
                if w >= 100 and nb < k_id and nb in arena.kfs:
                    add_edge(k_id, nb, pose_of(k_id), pose_of(nb))
        if not e_i:
            return
        t = self._t
        E = len(e_i)
        Rn, tn, sn = pose_graph.optimize_essential_graph(
            t(R0), t(t0), t(s0), t(fixed), t(np.ones(K, bool)),
            t(np.asarray(e_i, np.int64)), t(np.asarray(e_j, np.int64)),
            t(np.stack(e_R).astype(np.float32)),
            t(np.stack(e_t).astype(np.float32)),
            t(np.asarray(e_s, np.float32)), t(np.ones(E, bool)))
        buf = torch.cat([Rn.reshape(-1), tn.reshape(-1), sn]).cpu().numpy()
        Rn = buf[:9 * K].reshape(K, 3, 3)
        tn = buf[9 * K:12 * K].reshape(K, 3)
        sn = buf[12 * K:]
        # Poses = [R | t/s]; each point is corrected through its reference
        # keyframe's vertex: p_new = S_post^-1(S_init p) (reference
        # :960-1010).
        for k_id in kf_ids:
            i = index[k_id]
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = Rn[i]
            T[:3, 3] = tn[i] / max(sn[i], 1e-9)
            arena.kfs[k_id].Tcw = T
        eg_moved = []
        for mp in list(arena.mps.values()):
            ref_id = mp.ref_kf if mp.ref_kf in index else next(
                (k for k in mp.obs if k in index), None)
            if ref_id is None:
                continue
            i = index[ref_id]
            s_o, R_o, t_o = init_sim3[i]
            pc = s_o * (R_o @ mp.pos) + t_o
            arena.set_point_pos(mp, (Rn[i].T @ (pc - tn[i])) / max(sn[i], 1e-9))
            eg_moved.append(mp)
        arena.update_normals_many(eg_moved, self.scale_factors)

    # ---- global BA (upstream RunGlobalBundleAdjustment :340-410) ----------

    def _build_gba_problem(self):
        """The whole map as a BAProblem on the device (upstream
        GlobalBundleAdjustemnt, src/Optimizer.cc:22-27), the origin keyframe
        fixed, with the ids needed to apply the result; None when the map
        is too small. Built on the thread that owns the map."""
        arena = self.arena
        kf_ids = sorted(arena.kfs)
        C = len(kf_ids)
        index = {k: i for i, k in enumerate(kf_ids)}
        mp_ids = list(arena.mps)
        P = len(mp_ids)
        if P == 0 or C < 2:
            return None
        p_index = {m: i for i, m in enumerate(mp_ids)}
        e_cam, e_pt, e_uv, e_ur, e_is2 = [], [], [], [], []
        for m in mp_ids:
            for kf_id, fidx in arena.mps[m].obs.items():
                if kf_id not in index:
                    continue
                w_kf = arena.kfs[kf_id]
                e_cam.append(index[kf_id])
                e_pt.append(p_index[m])
                e_uv.append(w_kf.feats.xy_und[fidx])
                e_ur.append(w_kf.feats.ur_or_neg()[fidx])
                e_is2.append(self.inv_sigma2[w_kf.feats.octave[fidx]])
        if len(e_cam) < 20:
            return None
        t = self._t
        prob = local_ba.BAProblem(
            Tcw=t(np.stack([arena.kfs[k].Tcw for k in kf_ids])),
            cam_fixed=t(np.asarray([k == arena.kf_origin_id for k in kf_ids])),
            cam_valid=t(np.ones(C, bool)),
            points=t(np.stack([arena.mps[m].pos for m in mp_ids])),
            pt_valid=t(np.ones(P, bool)),
            e_cam=t(np.asarray(e_cam, np.int64)),
            e_pt=t(np.asarray(e_pt, np.int64)),
            e_uv=t(np.asarray(e_uv, np.float32)),
            e_inv_sigma2=t(np.asarray(e_is2, np.float32)),
            e_valid=t(np.ones(len(e_cam), bool)),
            e_ur=t(np.asarray(e_ur, np.float32)), bf=self.cfg.camera.bf)
        return prob, kf_ids, mp_ids

    def _start_global_ba(self):
        """Launch (or relaunch) global BA; a loop arriving while one is in
        flight aborts it first (upstream mbStopGBA, :255-263)."""
        snap = self._build_gba_problem()
        if snap is None:
            return
        if self.gba.running():
            self.gba.abort()
        self.gba.start(snap, self.cfg.camera, sync=self.sync_gba)
        if self.sync_gba:
            self.poll_gba()

    def poll_gba(self) -> bool:
        """Apply a finished global BA on the thread that owns the map, under
        the correction contract (module docstring). Returns whether a
        result was applied."""
        result = self.gba.take_result()
        if result is None:
            return False
        with self.arena.unlocked():
            self.arena.correction_lock.acquire()
        try:
            with self.arena.lock, self.stage_ms.stage("gba_apply"):
                return self._apply_gba(result)
        finally:
            self.arena.correction_lock.release()

    def _apply_gba(self, result) -> bool:
        """Keyframes of the snapshot take their optimized pose; keyframes
        born during the solve follow their parent through the spanning tree
        (Tcw_child = Tcp Tcw_parent_new, with Tcp taken against the
        parent's pose at apply time, upstream's mTcwBefGBA); points born
        during the solve re-anchor through their reference keyframe."""
        kf_ids, mp_ids, Tcw_n, X_n = result
        arena = self.arena
        index = {k: i for i, k in enumerate(kf_ids)}
        new_pose: Dict[int, np.ndarray] = {}
        for k in kf_ids:
            if k in arena.kfs and k != arena.kf_origin_id:
                new_pose[k] = Tcw_n[index[k]].copy()
        if arena.kf_origin_id in arena.kfs:
            new_pose[arena.kf_origin_id] = \
                arena.kfs[arena.kf_origin_id].Tcw.copy()
        pre_apply = {k: kf.Tcw.copy() for k, kf in arena.kfs.items()}
        changed = True
        while changed:    # one pass per tree level
            changed = False
            for k, kf in arena.kfs.items():
                if k in new_pose or kf.parent < 0 or kf.parent not in new_pose:
                    continue
                base = pre_apply.get(kf.parent)
                if base is None:
                    continue
                Tcp = pre_apply[k] @ np.linalg.inv(base)
                new_pose[k] = (Tcp @ new_pose[kf.parent]).astype(np.float32)
                changed = True
        for k, T in new_pose.items():
            if k in arena.kfs:
                arena.kfs[k].Tcw = T
        p_index = {m: i for i, m in enumerate(mp_ids)}
        moved = []
        for m, mp in list(arena.mps.items()):
            if m in p_index:
                arena.set_point_pos(mp, X_n[p_index[m]])
            else:
                ref = mp.ref_kf
                T_old = pre_apply.get(ref)
                if ref not in new_pose or T_old is None:
                    continue
                pc = T_old[:3, :3] @ mp.pos + T_old[:3, 3]
                T_new = new_pose[ref]
                arena.set_point_pos(mp, T_new[:3, :3].T @ (pc - T_new[:3, 3]))
            moved.append(mp)
        arena.update_normals_many(moved, self.scale_factors)
        arena.pose_epoch += 1       # map-wide rewrite (module docstring)
        self.n_gba_applied += 1
        return True


class GBARunner:
    """Interruptible global-BA worker (upstream GBA thread and mbStopGBA).
    The solve runs in chunks of CHUNK_ITERS LM iterations so an abort lands
    within one chunk; the result waits in take_result() for the thread
    that owns the map."""

    CHUNK_ITERS = 2
    N_CHUNKS = 5
    CG_ITERS = 50      # PCG iterations per LM step past GBA_DENSE_MAX_CAMS

    def __init__(self, stage_ms: StageTimer):
        self.stage_ms = stage_ms
        self._lock = threading.Lock()
        self._thread = None
        self._abort = False
        self._result = None

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def abort(self):
        self._abort = True
        self.join()
        self._thread = None

    def join(self):
        t = self._thread
        if t is not None:
            t.join()

    def start(self, snapshot, cam, sync=False):
        self.join()
        self._abort = False
        with self._lock:
            self._result = None
        if sync:
            self._solve(snapshot, cam)
            return
        self._thread = threading.Thread(target=self._solve,
                                        args=(snapshot, cam), daemon=True,
                                        name="gba")
        self._thread.start()

    def take_result(self):
        with self._lock:
            r, self._result = self._result, None
        return r

    def _solve(self, snapshot, cam):
        prob, kf_ids, mp_ids = snapshot
        C, P = prob.Tcw.shape[0], prob.points.shape[0]
        Tcw, X = prob.Tcw, prob.points
        with self.stage_ms.stage("gba_solve"):
            for _ in range(self.N_CHUNKS):
                if self._abort:
                    return      # superseded by a newer loop
                p = prob._replace(Tcw=Tcw, points=X)
                if C <= GBA_DENSE_MAX_CAMS:
                    Tcw, X = local_ba.bundle_adjust(
                        p, cam.fx, cam.fy, cam.cx, cam.cy,
                        n_iters=self.CHUNK_ITERS)
                else:
                    Tcw, X = local_ba.bundle_adjust_cg(
                        p, cam.fx, cam.fy, cam.cx, cam.cy,
                        n_iters=self.CHUNK_ITERS, cg_iters=self.CG_ITERS)
            buf = torch.cat([Tcw.reshape(-1), X.reshape(-1)]).cpu().numpy()
        if self._abort:
            return
        with self._lock:
            self._result = (kf_ids, mp_ids, buf[:16 * C].reshape(C, 4, 4),
                            buf[16 * C:].reshape(P, 3))
