"""Loop closing of the port against the JAX package on the CPU.

  * the batched keyframe-keyframe BoW match with its unconstrained retry,
    and the mutual Sim3-guided search: integer results, bit-equal;
  * DetectLoop over four consecutive keyframes on constructed BoWs: the
    same candidates and consistency groups;
  * ComputeSim3 + CorrectLoop on tests/test_loop_correction.py's drifted
    map, built once per package from the same seed: the same ok, matched
    keyframe and cur_matches keys, Scw within 1e-3 / 0.05 deg, every final
    keyframe pose within 1e-3, the same loop edges and last loop keyframe,
    and the drift removed. The port's PlaceRecognition has no vocabulary
    and is never handed a keyframe, so it cannot self-train (the JAX test
    builds its own with allow_self_train=False).
"""

import jax.numpy as jnp
import numpy as np

import orb_slam_system_tpu.config as jconfig
import orb_slam_system_tpu.mapping.arena as jarena
import orb_slam_system_tpu.mapping.keyframe_db as jkdb
import orb_slam_system_tpu.models.local_mapping as jlm
import orb_slam_system_tpu.models.loop_closing as jlc
import orb_slam_system_tpu.models.place_recognition as jpr
import orb_slam_system_tpu.ops.matching as jmatching
import orb_slam_system_tpu_torch.config as config
import orb_slam_system_tpu_torch.mapping.arena as arena_mod
import orb_slam_system_tpu_torch.mapping.keyframe_db as kdb
import orb_slam_system_tpu_torch.models.local_mapping as lm_mod
import orb_slam_system_tpu_torch.models.loop_closing as lc_mod
import orb_slam_system_tpu_torch.models.place_recognition as pr_mod
from orb_slam_system_tpu_torch.ops import matching
from orb_slam_system_tpu_torch.utils.interop import to_device

FX = FY = 300.0
CX, CY = 160.0, 120.0


def t(a):
    return to_device(np.asarray(a), "cpu")


def _cfg(cfg_m, n_slots=256):
    return cfg_m.SlamConfig(
        camera=cfg_m.CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, width=320,
                                  height=240),
        orb=cfg_m.ORBConfig(n_features=n_slots), sensor=cfg_m.Sensor.MONOCULAR)


def _rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def _flip_bits(rng, desc, n_bits):
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.choice(256, n_bits, replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return out


def test_search_by_node_id_retry_batch_bit_equal(rng):
    """Three candidates: node ids that agree (constrained pass), node ids
    that mostly disagree (fewer than 20 constrained matches: the retry),
    and an unrelated keyframe."""
    N1, N2 = 200, 180
    d1 = _rand_desc(rng, N1)
    ang1 = rng.uniform(0, 6.28, N1).astype(np.float32)
    node1 = rng.integers(0, 12, N1).astype(np.int32)
    v1 = rng.uniform(size=N1) > 0.1
    desc2, ang2, node2, v2 = [], [], [], []
    for c in range(3):
        perm = rng.permutation(N1)[:N2]
        d = (_flip_bits(rng, d1[perm], 8) if c < 2 else _rand_desc(rng, N2))
        desc2.append(d)
        ang2.append(((ang1[perm] + 0.3 + rng.normal(size=N2) * 0.05)
                     % 6.283).astype(np.float32))
        n = node1[perm].copy()
        if c == 1:
            n[: N2 - 10] = (n[: N2 - 10] + 1) % 12
        node2.append(n)
        v2.append(rng.uniform(size=N2) > 0.1)
    node1m = np.where(v1, node1, -1)
    node2m = np.where(np.stack(v2), np.stack(node2), -1)
    args = (d1, v1, ang1, node1m, np.stack(desc2), np.stack(v2),
            np.stack(ang2), node2m)
    got = matching.search_by_node_id_retry_batch(*(t(a) for a in args)).numpy()
    want = np.asarray(jmatching.search_by_node_id_retry_batch(
        *(jnp.asarray(a) for a in args), nn_ratio=0.75))
    np.testing.assert_array_equal(got, want)
    constrained = np.asarray(jmatching.search_by_node_id(
        *(jnp.asarray(a) for a in args[:4]),
        *(jnp.asarray(a[1]) for a in args[4:]), nn_ratio=0.75).idx2)
    assert (constrained >= 0).sum() < 20 < (got[1] >= 0).sum()   # the retry
    assert (got[0] >= 0).sum() >= 20


def test_search_by_sim3_bit_equal(rng):
    N1, N2 = 150, 140
    desc1, desc2 = _rand_desc(rng, N1), _rand_desc(rng, N2)
    xy1 = rng.uniform(0, 320, (N1, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 320, (N2, 2)).astype(np.float32)
    oct1 = rng.integers(0, 4, N1).astype(np.int32)
    oct2 = rng.integers(0, 4, N2).astype(np.int32)
    # Half of KF1's slots see a point that KF2 also sees, and back.
    pair = rng.permutation(N2)[:N1 // 2]
    mp1 = _flip_bits(rng, desc2[np.resize(pair, N1)], 20)
    proj12 = (xy2[np.resize(pair, N1)] + rng.normal(size=(N1, 2)) * 2).astype(np.float32)
    inv = np.full(N2, 0)
    inv[pair] = np.arange(len(pair))
    mp2 = _flip_bits(rng, desc1[inv], 20)
    proj21 = (xy1[inv] + rng.normal(size=(N2, 2)) * 2).astype(np.float32)
    rad1 = rng.uniform(4, 12, N1).astype(np.float32)
    rad2 = rng.uniform(4, 12, N2).astype(np.float32)
    lvl1 = np.clip(oct2[np.resize(pair, N1)] + rng.integers(0, 2, N1), 0, 3).astype(np.int32)
    lvl2 = np.clip(oct1[inv] + rng.integers(0, 2, N2), 0, 3).astype(np.int32)
    ok1, ok2 = rng.uniform(size=N1) > 0.1, rng.uniform(size=N2) > 0.1
    args = (mp1, proj12, rad1, lvl1, ok1, mp2, proj21, rad2, lvl2, ok2,
            desc1, xy1, rng.uniform(size=N1) > 0.05, oct1,
            desc2, xy2, rng.uniform(size=N2) > 0.05, oct2)
    got = matching.search_by_sim3(*(t(a) for a in args)).numpy()
    want = np.asarray(jmatching.search_by_sim3(*(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 20


# ---- DetectLoop -----------------------------------------------------------------


def _feats(mod, n=4):
    return mod.FrameFeatures(
        xy=np.zeros((n, 2), np.float32), xy_und=np.zeros((n, 2), np.float32),
        response=np.ones(n, np.float32), angle=np.zeros(n, np.float32),
        octave=np.zeros(n, np.int32), desc=np.zeros((n, 8), np.uint32),
        valid=np.ones(n, bool))


def _bow_chain(arena_m, kdb_m, pr_m, rng_seed=3):
    """14 keyframes in a covisibility chain (each linked to its two
    predecessors) with random BoWs; keyframes 10-13 revisit 0-3: they share
    most words with them. Returns (arena, place recognition)."""
    rng = np.random.default_rng(rng_seed)
    arena = arena_m.MapArena()
    bows = []
    for k in range(14):
        words = rng.choice(400, 60, replace=False)
        if k >= 10:
            words[:45] = bows[k - 10][0][:45]
        w = rng.uniform(0.5, 1.5, 60)
        bows.append((words, w / w.sum()))
    pr = pr_m.PlaceRecognition(None)
    pr.db = kdb_m.KeyFrameDatabase(None)
    for k in range(14):
        kf = arena.new_keyframe(k, k / 30.0, np.eye(4, dtype=np.float32),
                                _feats(arena_m))
        kf.bow = {int(a): float(b) for a, b in zip(*bows[k])}
        for d in (1, 2):
            if k - d >= 0:
                kf.covis[k - d] = 30 // d
                arena.kfs[k - d].covis[k] = 30 // d
        pr.db.add(kf.id, kf.bow)
    return arena, pr


def test_detect_loop_consistency_matches_jax():
    results = []
    for arena_m, kdb_m, pr_m, cfg_m, make in (
            (jarena, jkdb, jpr, jconfig,
             lambda c, a, p: jlc.LoopCloser(c, a, p, None)),
            (arena_mod, kdb, pr_mod, config,
             lambda c, a, p: lc_mod.LoopCloser(c, a, p, None, device="cpu"))):
        arena, pr = _bow_chain(arena_m, kdb_m, pr_m)
        lc = make(_cfg(cfg_m), arena, pr)
        out = []
        for k in (10, 11, 12, 13):
            cands = lc.detect_loop(arena.kfs[k])
            out.append((cands, [(sorted(g), n) for g, n in lc.consistent_groups]))
        results.append((out, dict(lc.stats)))
    assert results[0] == results[1]
    calls = results[1][0]
    assert all(not c for c, _ in calls[:3]) and calls[3][0], calls


# ---- ComputeSim3 + CorrectLoop on a drifted map ------------------------------------


def _drifted_map(arena_m, cfg_m, seed=0):
    """tests/test_loop_correction.py's drifted_map fixture for one package:
    keyframes 0..9 along x observing one cloud; 8 and 9 revisit the views of
    0 and 1 with a drifted pose and duplicate points."""
    rng = np.random.default_rng(seed)
    n_slots = 256
    arena = arena_m.MapArena()
    cfg = _cfg(cfg_m, n_slots)
    world = rng.uniform(-2, 2, size=(120, 3)).astype(np.float32)
    world[:, 2] = rng.uniform(4, 7, size=120)
    descs = rng.integers(0, 2 ** 32, size=(120, 8), dtype=np.uint32)

    def pose_at(x_off):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -x_off
        return T

    drift = np.eye(4, dtype=np.float32)
    drift[0, 3], drift[1, 3] = 0.3, 0.12
    kfs = []
    for k in range(10):
        revisit = k >= 8
        x_off = (k - 8) * 0.4 + 0.2 if revisit else k * 0.4
        T_true = pose_at(x_off)
        T = (drift @ T_true) if revisit else T_true
        Xc = world @ T_true[:3, :3].T + T_true[:3, 3]
        uv = (Xc[:, :2] / Xc[:, 2:3] * [FX, FY] + [CX, CY]).astype(np.float32)
        vis = ((Xc[:, 2] > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < 315)
               & (uv[:, 1] > 5) & (uv[:, 1] < 235))
        idx = np.nonzero(vis)[0][:100]
        n = len(idx)
        xy = np.zeros((n_slots, 2), np.float32)
        xy[:n] = uv[idx]
        d = np.zeros((n_slots, 8), np.uint32)
        d[:n] = descs[idx]
        feats = arena_m.FrameFeatures(
            xy=xy, xy_und=xy.copy(), response=np.ones(n_slots, np.float32),
            angle=np.zeros(n_slots, np.float32),
            octave=np.zeros(n_slots, np.int32), desc=d,
            valid=np.arange(n_slots) < n)
        kf = arena.new_keyframe(k, k / 30.0, T, feats)
        kfs.append(kf)
        Tinv = np.linalg.inv(T)
        for slot, wi in enumerate(idx):
            pos = world[wi] if not revisit else (
                Tinv[:3, :3] @ Xc[wi] + Tinv[:3, 3]).astype(np.float32)
            mp = arena.new_point(pos, descs[wi], kf.id, kf.id)
            arena.add_observation(mp, kf, slot)
        arena.update_connections(kf)
        if kf.parent < 0 and k > 0:
            kf.parent = kfs[k - 1].id
            kfs[k - 1].children.add(kf.id)
    for mp in list(arena.mps.values()):
        arena.update_normal_and_depth(mp, np.asarray(cfg.orb.level_scales()))
    return arena, cfg, kfs


def _close_loop(arena, kfs, lc):
    cur, cand = kfs[8], kfs[0]
    before = cur.Tcw.copy()
    ok, matched, Scw, loop_points, cur_matches = lc.compute_sim3(cur, [cand.id])
    assert ok and matched.id == cand.id
    keys = sorted(cur_matches)
    lc.correct_loop(cur, matched, Scw, loop_points, cur_matches)
    return dict(Scw={k: np.asarray(v, np.float64) for k, v in Scw.items()},
                keys=keys, before=before, cur=cur.Tcw.copy(),
                poses={k: kf.Tcw.copy() for k, kf in arena.kfs.items()},
                loop_edges={k: sorted(kf.loop_edges) for k, kf in arena.kfs.items()},
                last=lc.last_loop_kf_id)


def test_compute_sim3_and_correct_loop_match_jax(monkeypatch):
    monkeypatch.setenv("ORB_SLAM_TPU_SYNC_GBA", "1")
    jar, jcfg, jkfs = _drifted_map(jarena, jconfig)
    jres = _close_loop(jar, jkfs, jlc.LoopCloser(
        jcfg, jar, jpr.PlaceRecognition(None, allow_self_train=False),
        jlm.LocalMapper(jcfg, jar)))
    par, pcfg, pkfs = _drifted_map(arena_mod, config)
    pr = pr_mod.PlaceRecognition(None, device="cpu")
    pres = _close_loop(par, pkfs, lc_mod.LoopCloser(
        pcfg, par, pr, lm_mod.LocalMapper(pcfg, par, "cpu"), device="cpu",
        sync_gba=True))
    assert not pr.ready
    assert pres["keys"] == jres["keys"]
    assert abs(pres["Scw"]["s"] - jres["Scw"]["s"]) < 1e-3
    np.testing.assert_allclose(pres["Scw"]["t"], jres["Scw"]["t"], atol=1e-3)
    M = pres["Scw"]["R"] @ jres["Scw"]["R"].T
    assert np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1))) < 0.05
    assert sorted(pres["poses"]) == sorted(jres["poses"])
    for k in pres["poses"]:
        np.testing.assert_allclose(pres["poses"][k], jres["poses"][k], atol=1e-3)
    assert pres["loop_edges"] == jres["loop_edges"]
    assert pres["last"] == jres["last"] == pkfs[8].id
    # The drift is removed in both (tests/test_loop_correction.py's bar).
    true_pose = np.eye(4, dtype=np.float32)
    true_pose[0, 3] = -0.2
    for res in (pres, jres):
        err_before = np.abs(res["before"] - true_pose).max()
        assert err_before > 0.1
        assert np.abs(res["cur"] - true_pose).max() < 0.3 * err_before
    assert abs(pres["Scw"]["s"] - 1.0) < 0.05
