"""Map checkpoint / resume.

Copy of orb_slam_system_tpu/mapping/serialize.py for the port, with the
same format and keys: the port's MapArena is a copy of the JAX one, so a
map file written by either package loads in the other.

The reference leaves SaveMap/LoadMap as an explicit TODO
(include/System.h:94-96); only terminal trajectory exports exist. This
module implements real map persistence: the whole arena — keyframes with
their padded feature arrays, map points with observation lists,
covisibility/spanning-tree/loop topology — round-trips through one
compressed .npz of flat arrays.
"""

from __future__ import annotations

import numpy as np

from orb_slam_system_tpu_torch.mapping.arena import (
    FrameFeatures,
    KeyFrameRec,
    MapArena,
    MapPointRec,
)

FORMAT_VERSION = 2   # v2: + kf_u_right / kf_depth stereo channels


def save_map(arena: MapArena, path: str):
    with arena.lock:   # consistent snapshot vs the async mapping worker
        return _save_map_locked(arena, path)


def _save_map_locked(arena: MapArena, path: str):
    kf_ids = sorted(arena.kfs)
    K = len(kf_ids)
    mp_ids = sorted(arena.mps)
    P = len(mp_ids)
    # Keyframes may carry different padded slot counts (the mono-init
    # keyframes come from the 2x-features extractor) — pad to the max.
    n_slots = max((arena.kfs[k].feats.n_slots for k in kf_ids), default=0)

    def pad_feat(a, fill=0):
        n = a.shape[0]
        if n == n_slots:
            return a
        pad_shape = (n_slots - n,) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, a.dtype)], axis=0)

    data = {
        "version": np.asarray(FORMAT_VERSION),
        "kf_ids": np.asarray(kf_ids, np.int64),
        "next_kf_id": np.asarray(arena.next_kf_id),
        "next_mp_id": np.asarray(arena.next_mp_id),
        "kf_origin_id": np.asarray(arena.kf_origin_id),
    }
    if K:
        data.update({
            "kf_frame_id": np.asarray([arena.kfs[k].frame_id for k in kf_ids]),
            "kf_ts": np.asarray([arena.kfs[k].timestamp for k in kf_ids]),
            "kf_Tcw": np.stack([arena.kfs[k].Tcw for k in kf_ids]),
            "kf_parent": np.asarray([arena.kfs[k].parent for k in kf_ids]),
            "kf_mp_ids": np.stack(
                [pad_feat(arena.kfs[k].mp_ids, -1) for k in kf_ids]),
            "kf_xy": np.stack([pad_feat(arena.kfs[k].feats.xy) for k in kf_ids]),
            "kf_xy_und": np.stack(
                [pad_feat(arena.kfs[k].feats.xy_und) for k in kf_ids]),
            "kf_resp": np.stack(
                [pad_feat(arena.kfs[k].feats.response) for k in kf_ids]),
            "kf_angle": np.stack(
                [pad_feat(arena.kfs[k].feats.angle) for k in kf_ids]),
            "kf_octave": np.stack(
                [pad_feat(arena.kfs[k].feats.octave) for k in kf_ids]),
            "kf_desc": np.stack(
                [pad_feat(arena.kfs[k].feats.desc) for k in kf_ids]),
            "kf_valid": np.stack(
                [pad_feat(arena.kfs[k].feats.valid, False) for k in kf_ids]),
            # Stereo/RGB-D channels (mvuRight/mvDepth): persisted so resumed
            # maps keep their 3-component stereo observation edges in BA
            # (-1 = mono feature / absent, matching ur_or_neg()).
            "kf_u_right": np.stack([
                pad_feat(arena.kfs[k].feats.u_right.astype(np.float32), -1.0)
                if arena.kfs[k].feats.u_right is not None
                else np.full(n_slots, -1.0, np.float32) for k in kf_ids]),
            "kf_depth": np.stack([
                pad_feat(arena.kfs[k].feats.depth.astype(np.float32), -1.0)
                if arena.kfs[k].feats.depth is not None
                else np.full(n_slots, -1.0, np.float32) for k in kf_ids]),
        })
        # Covisibility + loop edges as COO lists.
        ci, cj, cw = [], [], []
        li, lj = [], []
        for k in kf_ids:
            for nb, w in arena.kfs[k].covis.items():
                ci.append(k); cj.append(nb); cw.append(w)
            for le in arena.kfs[k].loop_edges:
                li.append(k); lj.append(le)
        data["covis_i"] = np.asarray(ci, np.int64)
        data["covis_j"] = np.asarray(cj, np.int64)
        data["covis_w"] = np.asarray(cw, np.int32)
        data["loop_i"] = np.asarray(li, np.int64)
        data["loop_j"] = np.asarray(lj, np.int64)
        node_ids = [
            pad_feat(arena.kfs[k].node_ids.astype(np.int32), -1)
            if arena.kfs[k].node_ids is not None
            else np.full(n_slots, -1, np.int32)
            for k in kf_ids
        ]
        data["kf_node_ids"] = np.stack(node_ids)
    data["mp_ids_arr"] = np.asarray(mp_ids, np.int64)
    if P:
        data.update({
            "mp_pos": np.stack([arena.mps[m].pos for m in mp_ids]),
            "mp_desc": np.stack([arena.mps[m].desc for m in mp_ids]),
            "mp_normal": np.stack([arena.mps[m].normal for m in mp_ids]),
            "mp_min_dist": np.asarray([arena.mps[m].min_dist for m in mp_ids]),
            "mp_max_dist": np.asarray([arena.mps[m].max_dist for m in mp_ids]),
            "mp_ref_kf": np.asarray([arena.mps[m].ref_kf for m in mp_ids]),
            "mp_first_kf": np.asarray([arena.mps[m].first_kf_id for m in mp_ids]),
            "mp_n_vis": np.asarray([arena.mps[m].n_visible for m in mp_ids]),
            "mp_n_found": np.asarray([arena.mps[m].n_found for m in mp_ids]),
        })
        oi, ok_, of = [], [], []
        for m in mp_ids:
            for kf_id, fidx in arena.mps[m].obs.items():
                oi.append(m); ok_.append(kf_id); of.append(fidx)
        data["obs_mp"] = np.asarray(oi, np.int64)
        data["obs_kf"] = np.asarray(ok_, np.int64)
        data["obs_feat"] = np.asarray(of, np.int64)
    np.savez_compressed(path, **data)


def load_map(path: str) -> MapArena:
    # Every array read out once: indexing the NpzFile itself, as the JAX
    # copy does (serialize.py:133-184), inflates the whole array again at
    # each per-keyframe and per-point access.
    with np.load(path, allow_pickle=False) as f:
        z = {k: f[k] for k in f.files}
    arena = MapArena()
    arena.next_kf_id = int(z["next_kf_id"])
    arena.next_mp_id = int(z["next_mp_id"])
    arena.kf_origin_id = int(z["kf_origin_id"])
    kf_ids = z["kf_ids"]
    for i, k in enumerate(kf_ids):
        u_right = depth = None
        if "kf_u_right" in z:
            ur = z["kf_u_right"][i]
            if (ur >= 0).any():
                u_right = ur.copy()
            dp = z["kf_depth"][i]
            if (dp >= 0).any():
                depth = dp.copy()
        feats = FrameFeatures(
            xy=z["kf_xy"][i], xy_und=z["kf_xy_und"][i],
            response=z["kf_resp"][i], angle=z["kf_angle"][i],
            octave=z["kf_octave"][i], desc=z["kf_desc"][i],
            valid=z["kf_valid"][i], u_right=u_right, depth=depth)
        kf = KeyFrameRec(
            id=int(k), frame_id=int(z["kf_frame_id"][i]),
            timestamp=float(z["kf_ts"][i]), Tcw=z["kf_Tcw"][i].copy(),
            feats=feats, mp_ids=z["kf_mp_ids"][i].copy(),
            parent=int(z["kf_parent"][i]))
        node_ids = z["kf_node_ids"][i]
        if (node_ids >= 0).any():
            kf.node_ids = node_ids.copy()
        arena.kfs[kf.id] = kf
    for a, b, w in zip(z.get("covis_i", []), z.get("covis_j", []),
                       z.get("covis_w", [])):
        if int(a) in arena.kfs:
            arena.kfs[int(a)].covis[int(b)] = int(w)
    for a, b in zip(z.get("loop_i", []), z.get("loop_j", [])):
        if int(a) in arena.kfs:
            arena.kfs[int(a)].loop_edges.add(int(b))
    for kf in arena.kfs.values():
        if kf.parent >= 0 and kf.parent in arena.kfs:
            arena.kfs[kf.parent].children.add(kf.id)
    mp_ids = z["mp_ids_arr"]
    for i, m in enumerate(mp_ids):
        mp = MapPointRec(
            id=int(m), pos=z["mp_pos"][i].copy(), desc=z["mp_desc"][i].copy(),
            obs={}, normal=z["mp_normal"][i].copy(),
            min_dist=float(z["mp_min_dist"][i]),
            max_dist=float(z["mp_max_dist"][i]),
            ref_kf=int(z["mp_ref_kf"][i]),
            first_kf_id=int(z["mp_first_kf"][i]),
            n_visible=int(z["mp_n_vis"][i]), n_found=int(z["mp_n_found"][i]))
        arena.mps[mp.id] = mp
    for m, kf_id, fidx in zip(z.get("obs_mp", []), z.get("obs_kf", []),
                              z.get("obs_feat", [])):
        mp = arena.mps.get(int(m))
        if mp is not None:
            mp.obs[int(kf_id)] = int(fidx)
    return arena
