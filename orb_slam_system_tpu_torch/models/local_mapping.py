"""Local mapping: keyframe processing, point culling, triangulation +
fusion, local BA, keyframe culling.

Port of orb_slam_system_tpu/models/local_mapping.py (reference
LocalMapping). `process_pending` drains the keyframe queue in two phases
(JAX local_mapping.py:238-307): expansion, per queued keyframe
process_new_keyframe, cull_map_points and tri_and_fuse (fusion only for the
backlog's last keyframe); then refinement, one local BA and one
keyframe-culling pass on the newest keyframe of the batch, run even when
the tracker refilled the queue meanwhile, and the loop-closer hand-off.
The System calls it inline after each tracked frame (synchronous mapping,
the default), or `start_async` runs it on a worker thread (the reference's
LocalMapping thread): every stage holds `arena.lock`, released around its
device fetch (`arena.unlocked()`) so the tracker's host work goes on
meanwhile; `_busy` and `_expanding` tell the tracker's keyframe admission
where the worker is (models/tracking_init.py). The worker and the tracker
both queue their device work on the default CUDA stream, so it runs in
one order on the card.

Triangulation + fusion run as two chained device steps with one packed
fetch (ops/mapper_fused.py), local BA as one packed fetch
(solvers/local_ba.py); the arena bookkeeping stays on the host. Each
processed keyframe is indexed for place recognition (BoW, keyframe
database) when a PlaceRecognition service is given, and every keyframe of
the batch still alive after culling is handed to the loop closer
(`loop_closer`, set by the System) in insertion order.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import Sensor, SlamConfig
from orb_slam_system_tpu_torch.mapping.arena import KeyFrameRec, MapArena
from orb_slam_system_tpu_torch.ops import mapper_fused, matching
from orb_slam_system_tpu_torch.solvers.local_ba import (
    BAProblem, local_bundle_adjustment_packed, unpack_local_ba)
from orb_slam_system_tpu_torch.utils.interop import to_device
from orb_slam_system_tpu_torch.utils.metrics import StageTimer, fetch
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy

# Local BA window: at most BA_CAMS cameras (window + fixed boundary),
# BA_POINTS points and BA_EDGES edges (the JAX package's caps; its size
# buckets existed to bound XLA recompiles and are not carried over).
BA_CAMS = 16
BA_POINTS = 2048
BA_EDGES = 8192
# Fusion-target cap (covisibility-ordered, so the weakest are dropped) and
# the direction-B union cap.
FUSE_T_MAX = 64
FUSE_PB_MAX = 4096


def _pad_slots(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad a per-slot feature array to n slots (keyframes from the
    mono-init 2x extractor carry more slots than regular ones)."""
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


class LocalMapper:
    def __init__(self, cfg: SlamConfig, arena: MapArena, device="cuda",
                 place_rec=None):
        set_f32_policy()
        self.cfg = cfg
        self.arena = arena
        self.place_rec = place_rec
        self.loop_closer = None  # set by System
        self.device = torch.device(device)
        self.queue: deque[int] = deque()
        self.recent_points: list[tuple[int, int]] = []  # (mp_id, birth_kf_id)
        self.scale_factors = np.asarray(cfg.orb.level_scales(), np.float32)
        self.inv_sigma2 = (1.0 / self.scale_factors ** 2).astype(np.float32)
        # MapPointCulling observation threshold: 2 mono, 3 stereo/RGB-D
        # (reference LocalMapping.cc:137-151 cnThObs).
        self.cull_obs_th = 2 if cfg.sensor == Sensor.MONOCULAR else 3
        self.stage_ms = StageTimer("mapping")
        # The worker thread (start_async) and what the tracker reads of it:
        # _busy while it processes a batch; _expanding from the pop of a
        # queued keyframe until the batch's triangulation + fusion landed
        # (the tracker's backpressure drain may release there and let local
        # BA and culling overlap the next frames, as the reference's
        # concurrent LocalMapping thread does).
        self._thread = None
        self._cv = None
        self._stop = False
        self._busy = False
        self._expanding = False
        self.worker_errors = 0

    def _t(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    # ---- queue and thread protocol (reference :305-458) ---------------------

    def insert_keyframe(self, kf_id: int):
        self.queue.append(kf_id)
        cv = self._cv
        if cv is not None:
            with cv:
                cv.notify()

    def accepting(self) -> bool:
        return len(self.queue) == 0 and not self._busy

    @property
    def is_async(self) -> bool:
        """True while the worker thread runs."""
        return self._thread is not None

    def interrupt_ba(self):
        """Reference mbAbortBA, which the tracker raises for a keyframe it
        wants into a busy mapper. The local BA here is one device solve that
        cannot stop midway, so there is nothing to interrupt: the batch
        structure of process_pending does the catching up."""

    def reset(self):
        """Drain the worker (callers must not hold arena.lock), then drop
        the queue and the recent points."""
        self.flush()
        self.queue.clear()
        self.recent_points.clear()

    def start_async(self):
        """Run process_pending on a worker thread (the reference's
        LocalMapping thread) until stop_async."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = False
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="local_mapping")
        self._thread.start()

    def stop_async(self):
        t = self._thread
        if t is None:
            return
        self._stop = True
        with self._cv:
            self._cv.notify()
        t.join()
        self._thread = None
        self._cv = None

    def flush(self, timeout: float = 60.0):
        """Block until the worker has drained the queue (no worker: return
        at once). Raises on timeout rather than let a caller (reset) clear
        the queue under a keyframe still in a stage. The caller must not
        hold arena.lock: the worker's stages wait for it."""
        if self._thread is None:
            return
        t0 = time.monotonic()
        while (self.queue or self._busy) and time.monotonic() - t0 < timeout:
            time.sleep(0.002)
        if self.queue or self._busy:
            raise RuntimeError(
                f"local-mapping flush timed out after {timeout:.0f} s "
                f"(queue {len(self.queue)}, busy {self._busy}): is arena.lock "
                f"held by the caller?")

    def _worker(self):
        while True:
            with self._cv:
                while not self.queue and not self._stop:
                    self._cv.wait(0.05)
            if self._stop and not self.queue:
                return
            try:
                self._busy = True
                self._expanding = True
                self.process_pending()
            except Exception:  # noqa: BLE001 - the thread must survive
                # A dead worker would stop draining the queue and stall the
                # next flush; count the error, report it, drop the keyframe
                # and keep serving.
                self.worker_errors += 1
                print("[local_mapping] worker error (keyframe dropped):",
                      file=sys.stderr)
                traceback.print_exc()
            finally:
                self._busy = False
                self._expanding = False

    def process_pending(self):
        """Drain the keyframe queue (reference Run / ProcessKeyFrames).
        Per-stage wall time goes to self.stage_ms. _expanding is cleared
        however it ends: stuck True, every later backpressure drain would
        wait out its whole timeout."""
        try:
            self._process_pending()
        finally:
            self._expanding = False

    def _process_pending(self):
        t = self.stage_ms
        lk = self.arena.lock
        while self.queue:
            # Expansion. _expanding goes up before the pop: from the pop
            # until the triangulation lands the queue no longer shows the
            # keyframe.
            self._expanding = True
            batch: list[KeyFrameRec] = []
            while self.queue:
                kf = self.arena.kfs.get(self.queue.popleft())
                if kf is None:
                    continue
                with t.stage("process_new_kf"), lk:
                    self.process_new_keyframe(kf)
                with t.stage("cull_points"), lk:
                    self.cull_map_points(kf)
                # Fusion joins only for the backlog's last keyframe
                # (reference Run runs SearchInNeighbors iff the queue is
                # empty).
                with t.stage("tri_fuse"), lk:
                    self.tri_and_fuse(kf, do_fuse=not self.queue)
                batch.append(kf)
            self._expanding = False
            if not batch:
                continue
            # Refinement: one local BA and keyframe cull per batch, on its
            # newest keyframe, even if the queue refilled meanwhile (gated
            # on an empty queue they starved under ~1 keyframe a frame in
            # the JAX package's endurance runs).
            kf = batch[-1]
            if self.arena.n_keyframes() > 2 and kf.id in self.arena.kfs:
                with t.stage("local_ba"), lk:
                    self.local_ba(kf)
            if kf.id in self.arena.kfs:
                with t.stage("cull_kfs"), lk:
                    self.cull_keyframes(kf)
            # Hand-off to loop closing (reference Run :72): every batch
            # keyframe still alive, in insertion order.
            if self.loop_closer is not None:
                for bkf in batch:
                    if bkf.id in self.arena.kfs:
                        with t.stage("loop_closer"), lk:
                            self.loop_closer.process(bkf.id)

    def process_new_keyframe(self, kf: KeyFrameRec):
        """Reference ProcessNewKeyFrame: bind tracked map points, refresh
        their statistics in one batched arena pass, update covisibility,
        index the keyframe for place recognition."""
        fresh = []
        for idx, mid in enumerate(kf.mp_ids):
            if mid < 0:
                continue
            mp = self.arena.mps.get(int(mid))
            if mp is None or mp.bad:
                kf.mp_ids[idx] = -1
                continue
            if kf.id not in mp.obs:
                self.arena.add_observation(mp, kf, idx)
                fresh.append(mp)
        if fresh:
            self.arena.compute_distinctive_many(fresh)
            self.arena.update_normals_many(fresh, self.scale_factors)
        self.arena.update_connections(kf)
        # BoW + keyframe-database indexing (reference ComputeBoW and
        # KeyFrameDatabase::add).
        if self.place_rec is not None:
            self.place_rec.on_new_keyframe(kf, self.arena)

    def cull_map_points(self, kf: KeyFrameRec):
        """Reference MapPointCulling."""
        keep = []
        for mp_id, birth in self.recent_points:
            mp = self.arena.mps.get(mp_id)
            if mp is None or mp.bad:
                continue
            age = kf.id - birth
            if mp.found_ratio() < 0.25:
                self.arena.set_point_bad(mp)
            elif age >= 2 and len(mp.obs) <= self.cull_obs_th:
                self.arena.set_point_bad(mp)
            elif age < 3:
                keep.append((mp_id, birth))
        self.recent_points = keep

    # ---- triangulation + fusion ---------------------------------------------

    def _compute_f12(self, kf1: KeyFrameRec, kf2: KeyFrameRec) -> np.ndarray:
        """Fundamental matrix mapping kp1 -> epipolar line in image 2
        (reference ComputeF12)."""
        K = self.cfg.camera.K
        R1, t1 = kf1.Tcw[:3, :3], kf1.Tcw[:3, 3]
        R2, t2 = kf2.Tcw[:3, :3], kf2.Tcw[:3, 3]
        R12 = R1 @ R2.T
        t12 = -R12 @ t2 + t1
        tx = np.array([[0, -t12[2], t12[1]],
                       [t12[2], 0, -t12[0]],
                       [-t12[1], t12[0], 0]], np.float64)
        Kinv = np.linalg.inv(K.astype(np.float64))
        return (Kinv.T @ tx @ R12 @ Kinv).astype(np.float32)

    def _median_scene_depth(self, kf: KeyFrameRec) -> float:
        """Reference KeyFrame::ComputeSceneMedianDepth."""
        zs = []
        R2 = kf.Tcw[2, :3]
        t2 = kf.Tcw[2, 3]
        for mid in kf.mp_ids:
            if mid >= 0:
                mp = self.arena.mps.get(int(mid))
                if mp is not None and not mp.bad:
                    zs.append(float(R2 @ mp.pos + t2))
        return float(np.median(zs)) if zs else -1.0

    def _tri_candidates(self, kf: KeyFrameRec):
        """Triangulation neighbours (reference CreateNewMapPoints: the 20
        best covisible keyframes passing the baseline / median-depth gate)
        with their epipolar geometry: a list of (kf2, F12, epipole_xy)."""
        K = self.cfg.camera.K
        O1 = kf.camera_center()
        cand = []
        for nb_id in self.arena.covisible_ordered(kf, 20):
            kf2 = self.arena.kfs.get(nb_id)
            if kf2 is None or kf2.bad:
                continue
            baseline = float(np.linalg.norm(kf2.camera_center() - O1))
            med_depth = self._median_scene_depth(kf2)
            if med_depth <= 0 or baseline / med_depth < 0.01:
                continue
            F12 = self._compute_f12(kf, kf2)
            Xc = kf2.Tcw[:3, :3] @ O1 + kf2.Tcw[:3, 3]   # epipole of cam 1
            if abs(Xc[2]) < 1e-9:
                continue
            epi = np.array([K[0, 0] * Xc[0] / Xc[2] + K[0, 2],
                            K[1, 1] * Xc[1] / Xc[2] + K[1, 2]], np.float32)
            cand.append((kf2, F12, epi))
        return cand

    def _point_data(self, ids, n_pad: int):
        """Columnar fuse-projection data for an id list (-1 holes allowed),
        padded to n_pad: (pos, desc, 0.8*min_dist, 1.2*max_dist, normal,
        ok)."""
        pos = np.zeros((n_pad, 3), np.float32)
        desc = np.zeros((n_pad, 8), np.uint32)
        mind = np.zeros(n_pad, np.float32)
        maxd = np.ones(n_pad, np.float32)
        normal = np.zeros((n_pad, 3), np.float32)
        okv = np.zeros(n_pad, bool)
        if len(ids):
            rows, ok = self.arena.lookup_points(np.asarray(ids, np.int64))
            (_, c_pos, c_desc, c_mind, c_maxd, _n,
             c_normal) = self.arena.point_columns()
            r = rows[ok]
            w = np.nonzero(ok)[0]
            pos[w] = c_pos[r]
            desc[w] = c_desc[r]
            mind[w] = 0.8 * c_mind[r]
            maxd[w] = np.maximum(1.2 * c_maxd[r], 1e-6)
            normal[w] = c_normal[r]
            okv[w] = True
        return pos, desc, mind, maxd, normal, okv

    def _stack(self, kfs, f, n, fill=0):
        """Stack one per-slot array of several keyframes, padded to n."""
        return np.stack([_pad_slots(np.asarray(f(k)), n, fill) for k in kfs])

    def tri_and_fuse(self, kf: KeyFrameRec, do_fuse: bool = True):
        """CreateNewMapPoints + SearchInNeighbors as two chained device
        steps with ONE packed fetch (ops/mapper_fused): epipolar search,
        DLT, all acceptance gates and both fusion directions (the new
        points included) run on the device; the host applies the arena
        bookkeeping from the packed result."""
        cam = self.cfg.camera
        orb = self.cfg.orb
        st = self.stage_ms
        t = self._t
        with st.stage("tri_fuse_prep"):
            cand = self._tri_candidates(kf)
        if not cand:
            # No triangulation geometry this insertion: plain fusion only.
            if do_fuse:
                self.search_in_neighbors(kf)
            return
        with st.stage("tri_fuse_prep"):
            targets: list = []
            union: list = []
            if do_fuse:
                t_ids, union = self._fuse_sets(kf)
                targets = [self.arena.kfs[i] for i in t_ids][:FUSE_T_MAX]
                do_fuse = bool(targets)
            # Direction-A ids: the current keyframe's bindings, slot-aligned,
            # before point creation changes kf.mp_ids.
            src_slot_ids = [int(m) for m in kf.mp_ids]
            nbs = [c[0] for c in cand]
            M = len(nbs)
            n2 = max(k.feats.n_slots for k in nbs)
            Kc = cam.K.astype(np.float32)
            N1 = kf.feats.n_slots
            O1 = t(kf.camera_center().astype(np.float32))
            Tcw1 = t(kf.Tcw.astype(np.float32))
            xy1, desc1, oct1 = (t(kf.feats.xy_und), t(kf.feats.desc),
                                t(kf.feats.octave))
            nb_O = t(np.stack([k.camera_center() for k in nbs]).astype(np.float32))
            scale_factors = t(self.scale_factors)
            tri_args = (
                xy1, desc1, t(kf.feats.valid & (kf.mp_ids < 0)), oct1,
                t(kf.feats.angle),
                t(self._stack(nbs, lambda k: k.feats.xy_und, n2)),
                t(self._stack(nbs, lambda k: k.feats.desc, n2)),
                t(self._stack(nbs, lambda k: k.feats.valid & (k.mp_ids < 0), n2)),
                t(self._stack(nbs, lambda k: k.feats.octave, n2)),
                t(self._stack(nbs, lambda k: k.feats.angle, n2)),
                t(np.stack([c[1] for c in cand])),
                t(np.stack([c[2] for c in cand])),
                t(np.ones(M, bool)),
                t(Kc @ kf.Tcw[:3, :]),
                t(np.stack([Kc @ k.Tcw[:3, :] for k in nbs])),
                Tcw1, t(np.stack([k.Tcw for k in nbs]).astype(np.float32)),
                O1, nb_O,
                t(np.linalg.inv(cam.K.astype(np.float64)).astype(np.float32)),
                cam.fx, cam.fy, cam.cx, cam.cy,
                t(self.inv_sigma2), scale_factors, 1.5 * orb.scale_factor)
            T = PB = 0
            if do_fuse:
                T = len(targets)
                n2t = max(k.feats.n_slots for k in targets)
                union = union[:FUSE_PB_MAX]
                PB = max(len(union), 1)
                A = self._point_data(src_slot_ids, N1)
                B = self._point_data(union, PB)
                fuse_args = (
                    xy1, desc1, t(kf.feats.valid), oct1, Tcw1, O1, nb_O,
                    cam.fx, cam.fy, cam.cx, cam.cy,
                    float(cam.width), float(cam.height),
                    scale_factors, float(np.log(orb.scale_factor)),
                    t(self._stack(targets, lambda k: k.feats.xy_und, n2t)),
                    t(self._stack(targets, lambda k: k.feats.desc, n2t)),
                    t(self._stack(targets, lambda k: k.feats.valid, n2t)),
                    t(self._stack(targets, lambda k: k.feats.octave, n2t)),
                    t(np.stack([k.Tcw[:3, :3] for k in targets]).astype(np.float32)),
                    t(np.stack([k.Tcw[:3, 3] for k in targets]).astype(np.float32)),
                    t(np.stack([k.camera_center() for k in targets]).astype(np.float32)),
                    t(np.ones(T, bool)),
                    *(t(a) for a in A), *(t(a) for a in B))
        with st.stage("tri_fuse_device"), self.arena.unlocked():
            tri_dev = mapper_fused.tri_step(*tri_args)
            if do_fuse:
                buf = mapper_fused.fuse_step(tri_dev, *fuse_args)
            else:
                buf = tri_dev.reshape(-1)
            buf = fetch(buf, "mapping")
        with st.stage("tri_fuse_merge"):
            tri, idxA, idxB = mapper_fused.unpack_tri_fuse(
                buf, N1, T, 2 * N1, PB, do_fuse)
            # Create the accepted points (the device gates decide; the claim
            # re-checks only guard against stale slots).
            created = []
            created_ids = [-1] * N1
            for i1 in np.nonzero(tri[:, 0] > 0.5)[0]:
                kf2 = nbs[int(tri[i1, 1])]
                j2 = int(tri[i1, 2])
                if j2 < 0 or kf.mp_ids[i1] >= 0 or kf2.mp_ids[j2] >= 0:
                    continue
                mp = self.arena.new_point(tri[i1, 3:6], kf.feats.desc[int(i1)],
                                          kf.id, kf.id)
                self.arena.add_observation(mp, kf, int(i1))
                self.arena.add_observation(mp, kf2, j2)
                self.recent_points.append((mp.id, kf.id))
                created.append(mp)
                created_ids[int(i1)] = mp.id
            if created:
                self.arena.compute_distinctive_many(created)
                self.arena.update_normals_many(created, self.scale_factors)
            if do_fuse:
                idsA = src_slot_ids + created_ids
                touched: dict = {}
                for j, t_kf in enumerate(targets):
                    self._merge_fuse_matches(t_kf, idsA, idxA[j], touched)
                self._merge_fuse_matches(kf, union, idxB, touched)
                self._refresh_touched(touched)
                self.arena.update_connections(kf)

    def _fuse_sets(self, kf: KeyFrameRec):
        """Fusion targets (first + second order covisible neighbours,
        reference SearchInNeighbors :240-258) and the union of their points
        (direction B)."""
        targets = []
        for nb in self.arena.covisible_ordered(kf, 20):
            targets.append(nb)
            nb_kf = self.arena.kfs.get(nb)
            if nb_kf is None:
                continue
            for nb2 in self.arena.covisible_ordered(nb_kf, 5):
                if nb2 != kf.id and nb2 not in targets:
                    targets.append(nb2)
        targets = [t for t in targets if t in self.arena.kfs]
        union: list[int] = []
        seen: set[int] = set()
        for t_id in targets:
            for m in self.arena.kfs[t_id].mp_ids:
                if m >= 0 and int(m) not in seen and int(m) in self.arena.mps:
                    seen.add(int(m))
                    union.append(int(m))
        return targets, union

    def search_in_neighbors(self, kf: KeyFrameRec):
        """Map-point fusion with the first + second order covisible
        neighbours alone (tri_and_fuse's route when the keyframe has no
        triangulation neighbour): the current keyframe's points into every
        target, the targets' union into the current keyframe, one batched
        device search (ORBmatcher::Fuse semantics: the more-observed point
        survives)."""
        targets, union = self._fuse_sets(kf)
        if not targets:
            return
        src_ids = [int(m) for m in kf.mp_ids
                   if m >= 0 and int(m) in self.arena.mps]
        jobs = [(self.arena.kfs[t], src_ids) for t in targets]
        jobs.append((kf, union))
        jobs = [(dkf, ids) for dkf, ids in jobs if ids]
        if jobs:
            self._fuse_jobs(jobs)
        self.arena.update_connections(kf)

    def _project_for_fuse_many(self, dst_kfs, ids, radius_th=3.0):
        """Host fuse-projection geometry (reference ORBmatcher::Fuse gates)
        of one point set into several keyframes. Returns (proj f32[M,P,2],
        radius f32[M,P], lvl i32[M,P], good bool[M,P])."""
        cam = self.cfg.camera
        mps = [self.arena.mps[m] for m in ids]
        pos = np.stack([mp.pos for mp in mps])
        normal = np.stack([mp.normal for mp in mps])
        maxd = np.asarray([max(1.2 * mp.max_dist, 1e-6) for mp in mps])
        mind = np.asarray([0.8 * mp.min_dist for mp in mps])
        R = np.stack([k.Tcw[:3, :3] for k in dst_kfs])
        tr = np.stack([k.Tcw[:3, 3] for k in dst_kfs])
        ctr = np.stack([k.camera_center() for k in dst_kfs])
        Xc = np.einsum("mij,pj->mpi", R, pos) + tr[:, None, :]
        z = Xc[..., 2]
        good = z > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = Xc[..., :2] / np.where(np.abs(z[..., None]) < 1e-9, 1e-9,
                                          z[..., None])
        proj = (proj * [cam.fx, cam.fy] + [cam.cx, cam.cy]).astype(np.float32)
        good &= ((proj[..., 0] >= 0) & (proj[..., 0] < cam.width)
                 & (proj[..., 1] >= 0) & (proj[..., 1] < cam.height))
        PO = pos[None] - ctr[:, None, :]
        dist = np.linalg.norm(PO, axis=2)
        good &= (dist >= mind[None]) & (dist <= maxd[None])
        good &= np.sum(PO * normal[None], axis=2) >= 0.5 * dist
        with np.errstate(divide="ignore", invalid="ignore"):
            lvl = np.ceil(np.log(np.maximum(maxd[None] / 1.2, 1e-9)
                                 / np.maximum(dist, 1e-9))
                          / np.log(self.cfg.orb.scale_factor))
        lvl = np.clip(np.nan_to_num(lvl, nan=0.0), 0,
                      self.cfg.orb.n_levels - 1).astype(np.int32)
        radius = (radius_th * self.scale_factors[lvl]).astype(np.float32)
        return proj, radius, lvl, good

    def _fuse_jobs(self, jobs, radius_th=3.0, replace_existing=False):
        """Fuse (destination keyframe, point ids) jobs with ONE batched
        device search, then merge job by job on the host (later jobs see
        earlier replacements); descriptors and normals are refreshed once
        over every touched survivor. replace_existing: the loop closer's
        SearchAndFuse(Scw) variant (see _merge_fuse_matches)."""
        M = len(jobs)
        P_pad = max(len(ids) for _, ids in jobs)
        projs = np.zeros((M, P_pad, 2), np.float32)
        radii = np.zeros((M, P_pad), np.float32)
        lvls = np.zeros((M, P_pad), np.int32)
        goods = np.zeros((M, P_pad), bool)
        descs = np.zeros((M, P_pad, 8), np.uint32)
        st = self.stage_ms
        with st.stage("fuse_prep"):
            for j, (dkf, ids) in enumerate(jobs):
                proj, radius, lvl, good = self._project_for_fuse_many(
                    [dkf], ids, radius_th)
                n = len(ids)
                projs[j, :n], radii[j, :n] = proj[0], radius[0]
                lvls[j, :n], goods[j, :n] = lvl[0], good[0]
                descs[j, :n] = np.stack([self.arena.mps[m].desc for m in ids])
            dkfs = [d for d, _ in jobs]
            n2 = max(k.feats.n_slots for k in dkfs)
            t = self._t
            args = (t(projs), t(radii), t(lvls), t(goods), t(descs),
                    t(self._stack(dkfs, lambda k: k.feats.xy_und, n2)),
                    t(self._stack(dkfs, lambda k: k.feats.desc, n2)),
                    t(self._stack(dkfs, lambda k: k.feats.valid, n2)),
                    t(self._stack(dkfs, lambda k: k.feats.octave, n2)),
                    t(np.zeros((M, n2), bool)))
        with st.stage("fuse_device"), self.arena.unlocked():
            idx2_all = fetch(matching.search_by_projection_set_batch(*args),
                             "mapping")
        with st.stage("fuse_merge"):
            touched: dict = {}
            for j, (dkf, ids) in enumerate(jobs):
                self._merge_fuse_matches(dkf, ids, idx2_all[j], touched,
                                         replace_existing)
            self._refresh_touched(touched)

    def _refresh_touched(self, touched):
        """One batched descriptor + normal/depth-band refresh for every
        survivor the fuse merges touched."""
        if touched:
            survivors = list(touched.values())
            self.arena.compute_distinctive_many(survivors)
            self.arena.update_normals_many(survivors, self.scale_factors)

    def _merge_fuse_matches(self, dst_kf: KeyFrameRec, ids, idx2, touched,
                            replace_existing=False):
        """Apply fuse decisions (reference Fuse :549-568): replace the
        less-observed duplicate, or add the missing observation. With
        replace_existing the incoming point always wins: the loop closer's
        SearchAndFuse(Scw) variant (reference Fuse(KF, Scw, ...) and
        LoopClosing::SearchAndFuse :302-317, where corrected loop points
        replace current-map duplicates unconditionally)."""
        for k in np.nonzero(idx2[:len(ids)] >= 0)[0]:
            mp = self.arena.mps.get(ids[k])
            if mp is None or mp.bad or dst_kf.id in mp.obs:
                continue
            j = int(idx2[k])
            existing = int(dst_kf.mp_ids[j])
            if existing >= 0:
                other = self.arena.mps.get(existing)
                if other is not None and not other.bad and other.id != mp.id:
                    if not replace_existing and len(other.obs) > len(mp.obs):
                        self.arena.replace_point(mp, other, refresh_desc=False)
                        touched[other.id] = other
                        touched.pop(mp.id, None)
                    else:
                        self.arena.replace_point(other, mp, refresh_desc=False)
                        touched[mp.id] = mp
                        touched.pop(other.id, None)
            else:
                self.arena.add_observation(mp, dst_kf, j)
                touched[mp.id] = mp

    # ---- local bundle adjustment ----------------------------------------------

    def local_ba(self, kf: KeyFrameRec):
        """Reference LocalBundleAdjustment: the current keyframe and its
        covisible keyframes free, the boundary keyframes observing their
        points fixed; one packed fetch of the solved window."""
        with self.stage_ms.stage("ba_prep"):
            prep = self._local_ba_prep(kf)
        if prep is None:
            return
        prob, cam_index, cam_fixed, pt_index, edge_refs = prep
        cam = self.cfg.camera
        C, P, E = prob.Tcw.shape[0], prob.points.shape[0], prob.e_cam.shape[0]
        with self.stage_ms.stage("ba_device"), self.arena.unlocked():
            buf = fetch(local_bundle_adjustment_packed(
                prob, cam.fx, cam.fy, cam.cx, cam.cy), "mapping")
            Tcw_new, X_new, inlier = unpack_local_ba(buf, C, P, E)
        with self.stage_ms.stage("ba_writeback"):
            self._local_ba_writeback(cam_index, cam_fixed, pt_index,
                                     edge_refs, Tcw_new, X_new, inlier)

    def _local_ba_prep(self, kf: KeyFrameRec):
        """Window, points and edges of the local BA problem, or None."""
        window = ([kf.id] + self.arena.covisible_ordered(kf, BA_CAMS - 2))
        window = window[:BA_CAMS - 1]
        window_set = set(window)
        pt_ids: list[int] = []
        seen = set()
        for w_id in window:
            w_kf = self.arena.kfs.get(w_id)
            if w_kf is None:
                continue
            for mid in w_kf.mp_ids:
                if mid >= 0 and int(mid) not in seen:
                    mp = self.arena.mps.get(int(mid))
                    if mp is not None and not mp.bad:
                        seen.add(int(mid))
                        pt_ids.append(int(mid))
        pt_ids = pt_ids[:BA_POINTS]
        pt_index = {m: i for i, m in enumerate(pt_ids)}
        # Fixed boundary cameras: observe window points, not in the window.
        fixed: list[int] = []
        for m in pt_ids:
            for kf_id in self.arena.mps[m].obs:
                if kf_id not in window_set and kf_id not in fixed:
                    fixed.append(kf_id)
        fixed = fixed[:BA_CAMS - len(window)]
        cams = window + fixed
        cam_index = {c: i for i, c in enumerate(cams)}
        C = len(cams)
        Tcw = np.stack([self.arena.kfs[c].Tcw for c in cams]).astype(np.float32)
        cam_fixed = np.array([(c in fixed) or (c == self.arena.kf_origin_id)
                              for c in cams])
        if cam_fixed.all():
            return None
        pts = np.stack([self.arena.mps[m].pos for m in pt_ids]).astype(np.float32) \
            if pt_ids else np.zeros((0, 3), np.float32)
        tri_pt: list[int] = []
        tri_cam: list[int] = []
        tri_fidx: list[int] = []
        edge_refs: list[tuple[int, int]] = []   # (mp_id, kf_id)
        for m in pt_ids:
            pi = pt_index[m]
            for kf_id, fidx in self.arena.mps[m].obs.items():
                ci = cam_index.get(kf_id)
                if ci is None or len(tri_pt) >= BA_EDGES:
                    continue
                tri_pt.append(pi)
                tri_cam.append(ci)
                tri_fidx.append(fidx)
                edge_refs.append((m, kf_id))
        n_e = len(tri_pt)
        if n_e < 10:
            return None
        e_cam = np.asarray(tri_cam, np.int64)
        fidx = np.asarray(tri_fidx, np.int64)
        e_uv = np.zeros((n_e, 2), np.float32)
        e_ur = np.full(n_e, -1.0, np.float32)     # stereo edges: u_right >= 0
        e_is2 = np.ones(n_e, np.float32)
        for c_id, ci in cam_index.items():
            rows = np.nonzero(e_cam == ci)[0]
            if rows.size == 0:
                continue
            w_kf = self.arena.kfs[c_id]
            e_uv[rows] = w_kf.feats.xy_und[fidx[rows]]
            e_ur[rows] = w_kf.feats.ur_or_neg()[fidx[rows]]
            e_is2[rows] = self.inv_sigma2[w_kf.feats.octave[fidx[rows]]]
        t = self._t
        prob = BAProblem(
            Tcw=t(Tcw), cam_fixed=t(cam_fixed), cam_valid=t(np.ones(C, bool)),
            points=t(pts), pt_valid=t(np.ones(len(pt_ids), bool)),
            e_cam=t(e_cam), e_pt=t(np.asarray(tri_pt, np.int64)),
            e_uv=t(e_uv), e_inv_sigma2=t(e_is2),
            e_valid=t(np.ones(n_e, bool)), e_ur=t(e_ur), bf=self.cfg.camera.bf)
        return prob, cam_index, cam_fixed, pt_index, edge_refs

    def _local_ba_writeback(self, cam_index, cam_fixed, pt_index, edge_refs,
                            Tcw_new, X_new, inlier):
        """Apply the solved window (reference :692-738)."""
        for c_id, i in cam_index.items():
            if not cam_fixed[i]:
                self.arena.kfs[c_id].Tcw = Tcw_new[i].copy()
        self.arena.version += 1  # point positions move (local-map cache)
        for m, i in pt_index.items():
            mp = self.arena.mps.get(m)
            if mp is not None:
                self.arena.set_point_pos(mp, X_new[i])
        for k, (m, kf_id) in enumerate(edge_refs):
            if not inlier[k]:
                mp = self.arena.mps.get(m)
                if mp is not None:
                    self.arena.erase_observation(mp, kf_id)
        self.arena.update_normals_many(
            [mp for m in pt_index
             if (mp := self.arena.mps.get(m)) is not None and not mp.bad],
            self.scale_factors)

    # ---- keyframe culling (reference KeyFrameCulling :382-410) ------------------

    def cull_keyframes(self, kf: KeyFrameRec):
        """Erase local keyframes whose map points are >= 90% observed by
        >= 3 other keyframes at the same or a finer scale; a columnar count
        over arena.obs_table() per neighbour."""
        obs_sorted = None
        for nb_id in self.arena.covisible_ordered(kf):
            nb = self.arena.kfs.get(nb_id)
            if nb is None or nb.id == self.arena.kf_origin_id:
                continue
            if obs_sorted is None or obs_sorted[0] != self.arena.version:
                kf_r, _, mp_r, oct_r = self.arena.obs_table()
                order = np.argsort(mp_r, kind="stable")
                mp_s, kf_s, oct_s = mp_r[order], kf_r[order], oct_r[order]
                uniq, start = np.unique(mp_s, return_index=True)
                end = np.append(start[1:], len(mp_s))
                obs_sorted = (self.arena.version, mp_s, kf_s, oct_s,
                              uniq, start, end)
            _, mp_s, kf_s, oct_s, uniq, start, end = obs_sorted
            slots = np.nonzero(nb.mp_ids >= 0)[0]
            if not len(slots) or not len(uniq):
                continue
            mids = nb.mp_ids[slots].astype(np.int64)
            pos = np.searchsorted(uniq, mids)
            posc = np.minimum(pos, len(uniq) - 1)
            found = (pos < len(uniq)) & (uniq[posc] == mids)
            slots, posc = slots[found], posc[found]
            n_pts = len(slots)
            if n_pts == 0:
                continue
            levels = nb.feats.octave[slots].astype(np.int64)
            s, e = start[posc], end[posc]
            lens = e - s
            ramp = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
            flat = np.repeat(s, lens) + ramp
            point_row = np.repeat(np.arange(n_pts), lens)
            fine = ((kf_s[flat] != nb.id)
                    & (oct_s[flat] <= levels[point_row] + 1))
            cnt = np.bincount(point_row[fine], minlength=n_pts)
            if int((cnt >= 3).sum()) > 0.9 * n_pts:
                self.arena.erase_keyframe(nb)
