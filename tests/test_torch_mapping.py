"""The port's initialization and mapping pieces against the JAX package on
the CPU, on the same inputs.

Realistic inputs come from a run of the JAX System (monocular, synchronous
mapping, vocabulary self-training off) over the first 12 frames of the
tests/test_e2e_mono.py orbit: the test records the arguments of its calls
to initialize_two_view, search_for_initialization, the initial global BA,
the local BAs and the tri/fuse steps, and feeds the same numpy arrays to
the port (utils/interop). Other inputs are seeded numpy.

Tolerances: indices and masks identical unless stated; BA poses within
1e-4, points within 1e-3 relative (float32 sums in another order); the
initializer's R21 and unit t21 within 1e-3 and its triangulated mask on
>= 99% of slots (eigen/singular vectors differ in sign between solvers);
the other two stated where they are set.
"""

import jax
import numpy as np
import pytest
import torch

import orb_slam_system_tpu.models.local_mapping as jlm
import orb_slam_system_tpu.models.tracking as jtracking
import orb_slam_system_tpu.ops.mapper_fused as jmf
import orb_slam_system_tpu.solvers.local_ba as jlba
from orb_slam_system_tpu.config import (CameraConfig as JCameraConfig,
                                        ORBConfig as JORBConfig,
                                        SlamConfig as JSlamConfig)
from orb_slam_system_tpu.models.system import System as JSystem
from orb_slam_system_tpu.ops import matching as jmatching
from orb_slam_system_tpu.solvers import initializer as jinit
from orb_slam_system_tpu.solvers.triangulate import triangulate_dlt as j_dlt
from orb_slam_system_tpu_torch.drivers.mono_synthetic import (make_config,
                                                              render_sequence)
from orb_slam_system_tpu_torch.ops import mapper_fused, matching
from orb_slam_system_tpu_torch.solvers import initializer, local_ba
from orb_slam_system_tpu_torch.solvers.triangulate import triangulate_dlt
from orb_slam_system_tpu_torch.utils.interop import (ba_problem_from_numpy,
                                                     init_inputs_from_numpy)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_FRAMES = 12


def to_t(a):
    """A recorded JAX argument -> the port's tensor (u32 descriptor words
    as their int32 bits, integers as int64); Python scalars pass."""
    if isinstance(a, (float, int)):
        return a
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy())
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.astype(np.float32))


def _np(x):
    return x if isinstance(x, (float, int)) else np.asarray(x)


@pytest.fixture(scope="module")
def rec():
    """Record the JAX System's solver and mapper calls over N_FRAMES."""
    calls = {"init": [], "search_init": [], "gba": [], "lba": [],
             "tri": [], "fuse": []}
    mp = pytest.MonkeyPatch()

    def wrap(mod, name, key):
        orig = getattr(mod, name)

        def w(*a, **k):
            out = orig(*a, **k)
            calls[key].append((jax.tree.map(_np, a), jax.tree.map(_np, k),
                               jax.tree.map(_np, out)))
            return out
        mp.setattr(mod, name, w)

    wrap(jtracking, "initialize_two_view", "init")
    wrap(jmatching, "search_for_initialization", "search_init")
    wrap(jlba, "global_bundle_adjustment", "gba")
    wrap(jlm, "local_bundle_adjustment_packed", "lba")
    wrap(jmf, "tri_step", "tri")
    wrap(jmf, "fuse_step", "fuse")
    try:
        pcfg = make_config(320, 240, 400)
        frames, _ = render_sequence(pcfg, 25)
        c = pcfg.camera
        cfg = JSlamConfig(camera=JCameraConfig(
            fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, fps=30.0, width=c.width,
            height=c.height), orb=JORBConfig(n_features=400))
        slam = JSystem(None, cfg)
        slam.place_rec.allow_self_train = False
        for i in range(N_FRAMES):
            slam.track_monocular(frames[i], i / 30.0)
    finally:
        mp.undo()
    assert calls["init"] and calls["gba"] and calls["lba"] and calls["fuse"]
    calls["cam"] = (c.fx, c.fy, c.cx, c.cy)
    return calls


def test_triangulate_dlt_matches_jax(rng):
    """Points within 1e-4 relative, w_ok identical; batched over two
    second views as the mapper calls it."""
    N = 300
    X = np.stack([rng.uniform(-1, 1, N), rng.uniform(-1, 1, N),
                  rng.uniform(2, 4, N)], 1)
    K = np.array([[400, 0, 160], [0, 400, 120], [0, 0, 1]], np.float64)
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.stack([K @ np.hstack([np.eye(3), [[tx], [0.02], [0.0]]])
                   for tx in (-0.2, 0.3)])
    proj = lambda P: (X @ P[:, :3].T + P[:, 3])[:, :2] / (X @ P[:, :3].T + P[:, 3])[:, 2:]
    uv1 = (proj(P1) + rng.normal(0, 0.3, (N, 2))).astype(np.float32)
    uv2 = np.stack([proj(P) + rng.normal(0, 0.3, (N, 2)) for P in P2]).astype(np.float32)
    P1, P2 = P1.astype(np.float32), P2.astype(np.float32)
    for m in range(2):
        jX, jok = j_dlt(uv1, uv2[m], P1, P2[m])
        pX, pok = triangulate_dlt(torch.from_numpy(uv1), torch.from_numpy(uv2[m]),
                                  torch.from_numpy(P1), torch.from_numpy(P2[m]))
        np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
        np.testing.assert_allclose(pX.numpy(), np.asarray(jX), rtol=1e-4, atol=1e-4)
    bX, _ = triangulate_dlt(torch.from_numpy(uv1), torch.from_numpy(uv2),
                            torch.from_numpy(P1), torch.from_numpy(P2))
    np.testing.assert_allclose(bX[1].numpy(), pX.numpy(), rtol=1e-6, atol=1e-6)


def test_ransac_sets_are_the_jax_sets():
    np.testing.assert_array_equal(initializer.make_ransac_sets(896, 200, 8, 0),
                                  jinit.make_ransac_sets(896, 200, 8, 0))


def test_initialize_two_view_matches_jax(rec):
    """Every initializer call of the recorded run (the failing attempts
    and the one that built the map): same success and model choice; where
    it succeeds, R21 and unit t21 within 1e-3 and the triangulated mask on
    >= 99% of slots."""
    assert any(bool(out.success) for _, _, out in rec["init"])
    for args, _, want in rec["init"]:
        got = initializer.initialize_two_view(*init_inputs_from_numpy(*args, "cpu"))
        assert bool(got.success) == bool(want.success)
        assert bool(got.used_homography) == bool(want.used_homography)
        if bool(want.success):
            np.testing.assert_allclose(got.R21.numpy(), want.R21, atol=1e-3)
            np.testing.assert_allclose(got.t21.numpy(), want.t21, atol=1e-3)
            agree = (got.is_triangulated.numpy() == want.is_triangulated).mean()
            assert agree >= 0.99, agree


def test_search_for_initialization_matches_jax(rec):
    for args, kw, want in rec["search_init"]:
        got = matching.search_for_initialization(
            *map(to_t, args), **{k: to_t(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.idx2.numpy(), want.idx2)


def _tri_search_args(tri_args):
    a = [to_t(x) for x in tri_args]
    # search_for_triangulation_batch(xy1..ang1, nb_*, F12, inv_sigma2,
    # epipole, nb_valid) from tri_step's argument list.
    return a[:10] + [a[10], a[24], a[11], a[12]]


def test_search_for_triangulation_matches_jax(rec):
    """Batched over the recorded neighbours, and the single-pair form on
    the first neighbour: identical indices."""
    for args, _, _ in rec["tri"]:
        sa = _tri_search_args(args)
        want = np.asarray(jmatching.search_for_triangulation_batch(
            *[np.asarray(x) for x in args[:10]], np.asarray(args[10]),
            np.asarray(args[24]), np.asarray(args[11]), np.asarray(args[12])))
        got = matching.search_for_triangulation_batch(*sa).numpy()
        np.testing.assert_array_equal(got, want)
        one = [np.asarray(x) for x in args[:5]] + [np.asarray(x)[0] for x in args[5:10]]
        want1 = jmatching.search_for_triangulation(
            *one, np.asarray(args[10])[0], np.asarray(args[24]),
            np.asarray(args[11])[0], True)
        got1 = matching.search_for_triangulation(
            *[to_t(x) for x in one], to_t(np.asarray(args[10])[0]),
            to_t(args[24]), to_t(np.asarray(args[11])[0]))
        np.testing.assert_array_equal(got1.idx2.numpy(), np.asarray(want1.idx2))


def _projection_sets(rec, rng, n_sets):
    """Projection-search inputs built from recorded keyframe features: map
    points are perturbed copies of the features' descriptors near their
    positions, windows and levels drawn from the seed."""
    xy, desc, _, octv = [np.asarray(a) for a in rec["tri"][-1][0][:4]]
    valid = np.asarray(rec["tri"][-1][0][2]) | (rng.uniform(size=len(xy)) < 0.5)
    sets = []
    for _ in range(n_sets):
        P = 400
        src = rng.integers(0, len(xy), P)
        d = desc[src].copy()
        flip = rng.integers(0, 32, (P, 8)).astype(np.uint32)
        d ^= (np.uint32(1) << flip) * (rng.uniform(size=(P, 8)) < 0.5)
        sets.append(dict(
            proj=(xy[src] + rng.normal(0, 3, (P, 2))).astype(np.float32),
            radius=rng.uniform(2, 12, P).astype(np.float32),
            lvl=np.clip(octv[src] + rng.integers(-1, 2, P), 0, 7).astype(np.int32),
            ok=rng.uniform(size=P) < 0.9, desc=d, xy=xy, d2=desc, v2=valid,
            o2=octv, already=rng.uniform(size=len(xy)) < 0.1))
    return sets


def test_search_by_projection_set_matches_jax(rec, rng):
    """Single and batched (max_dist TH_LOW as ORBmatcher::Fuse), with an
    exclusion set: identical indices, and a real share matched."""
    sets = _projection_sets(rec, rng, 3)
    keys = ("proj", "radius", "lvl", "ok", "desc", "xy", "d2", "v2", "o2",
            "already")
    for s in sets:
        want = np.asarray(jmatching.search_by_projection_set(
            *[s[k] for k in keys]).idx2)
        got = matching.search_by_projection_set(*[to_t(s[k]) for k in keys])
        np.testing.assert_array_equal(got.idx2.numpy(), want)
        assert (want >= 0).sum() > 50
    stacked = [np.stack([s[k] for s in sets]) for k in keys]
    want = np.asarray(jmatching.search_by_projection_set_batch(*stacked))
    got = matching.search_by_projection_set_batch(*map(to_t, stacked)).numpy()
    np.testing.assert_array_equal(got, want)


def test_search_by_node_id_matches_jax(rec, rng):
    """Reference-keyframe matching (all nodes 0, as without place
    recognition) and with random node ids and -1 holes."""
    a1, a2 = rec["tri"][0][0], rec["tri"][-1][0]
    d1, v1, g1 = np.asarray(a1[1]), np.asarray(a1[2]), np.asarray(a1[4])
    d2, g2 = np.asarray(a2[1]), np.asarray(a2[4])
    v2 = rng.uniform(size=len(d2)) < 0.95
    for nodes in ("zero", "random"):
        if nodes == "zero":
            n1 = np.where(v1, 0, -1).astype(np.int32)
            n2 = np.zeros(len(d2), np.int32)
        else:
            n1 = rng.integers(-1, 3, len(d1)).astype(np.int32)
            n2 = rng.integers(0, 3, len(d2)).astype(np.int32)
        args = (d1, v1, g1, n1, d2, v2, g2, n2)
        want = np.asarray(jmatching.search_by_node_id(*args).idx2)
        got = matching.search_by_node_id(*map(to_t, args)).idx2.numpy()
        np.testing.assert_array_equal(got, want)


def _ba_close(got_T, got_X, want_T, want_X, t_atol=1e-4):
    np.testing.assert_allclose(got_T[:, :3, :3], want_T[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got_T[:, :3, 3], want_T[:, :3, 3], atol=t_atol)
    scale = max(np.abs(want_X).max(), 1.0)
    np.testing.assert_allclose(got_X, want_X, atol=1e-3 * scale)


@pytest.mark.parametrize("which", ["two_view", "five_keyframes"])
def test_bundle_adjust_matches_jax(rec, which):
    """The initial 2-view global BA as recorded, and global BA (20
    iterations) plus bundle_adjust (10) on a recorded local window of >= 5
    keyframes. The 2-view problem fixes only the first camera, so the
    second camera's translation and the points share a free scale: float32
    sums taken in another order move its translation by up to ~7e-4
    (the system normalizes the scale right after), so its translation is
    held to 1e-3; rotations to 1e-4 everywhere."""
    fx, fy, cx, cy = rec["cam"]
    if which == "two_view":
        (prob, *_), kw, (want_T, want_X, want_inl) = rec["gba"][0]
        got_T, got_X, got_inl = local_ba.global_bundle_adjustment(
            ba_problem_from_numpy(prob, "cpu"), fx, fy, cx, cy, **kw)
        _ba_close(got_T.numpy(), got_X.numpy(), want_T, want_X, t_atol=1e-3)
        np.testing.assert_array_equal(got_inl.numpy(), want_inl)
        return
    prob = next(a[0] for a, _, _ in rec["lba"]
                if int(np.asarray(a[0].cam_valid).sum()) >= 5)
    pp = ba_problem_from_numpy(prob, "cpu")
    want_T, want_X, want_inl = jlba.global_bundle_adjustment(prob, fx, fy, cx, cy)
    got_T, got_X, got_inl = local_ba.global_bundle_adjustment(pp, fx, fy, cx, cy)
    _ba_close(got_T.numpy(), got_X.numpy(), np.asarray(want_T), np.asarray(want_X))
    assert (got_inl.numpy() == np.asarray(want_inl)).mean() >= 0.999
    want_T, want_X = jlba.bundle_adjust(prob, fx, fy, cx, cy, n_iters=10,
                                        use_huber=False)
    got_T, got_X = local_ba.bundle_adjust(pp, fx, fy, cx, cy, n_iters=10,
                                          use_huber=False)
    _ba_close(got_T.numpy(), got_X.numpy(), np.asarray(want_T), np.asarray(want_X))


def test_classify_outliers_matches_jax(rec):
    """Same state in, identical inlier masks, chi2 within 1e-3 relative."""
    fx, fy, cx, cy = rec["cam"]
    for args, _, _ in rec["lba"]:
        prob = args[0]
        want_inl, want_chi2 = jlba.classify_outliers(
            prob.Tcw, prob.points, prob, fx, fy, cx, cy)
        pp = ba_problem_from_numpy(prob, "cpu")
        got_inl, got_chi2 = local_ba.classify_outliers(
            pp.Tcw, pp.points, pp, fx, fy, cx, cy)
        np.testing.assert_array_equal(got_inl.numpy(), np.asarray(want_inl))
        np.testing.assert_allclose(got_chi2.numpy(), np.asarray(want_chi2),
                                   rtol=1e-3, atol=1e-3)


def test_local_bundle_adjustment_packed_matches_jax(rec):
    """Every recorded local BA of the run: poses within 1e-4, points 1e-3
    relative, edge inlier masks equal on >= 99.9% of edges."""
    for args, kw, want in rec["lba"]:
        prob, fx, fy, cx, cy = args
        C, P, E = (np.asarray(prob.Tcw).shape[0], np.asarray(prob.points).shape[0],
                   np.asarray(prob.e_cam).shape[0])
        got = local_ba.local_bundle_adjustment_packed(
            ba_problem_from_numpy(prob, "cpu"), fx, fy, cx, cy).numpy()
        gT, gX, ginl = local_ba.unpack_local_ba(got, C, P, E)
        wT, wX, winl = jlba.unpack_local_ba(np.asarray(want), C, P, E)
        _ba_close(gT, gX, wT, wX)
        assert (ginl == winl).mean() >= 0.999


def test_tri_and_fuse_steps_match_jax(rec):
    """tri_step on each recorded insertion: identical accept/winner/index
    columns; points within 3e-3 relative (each solver takes the DLT point
    from the smallest eigenvector of a float32 A^T A whose entries reach
    ~1e5, which carries ~1e-3 relative error: the largest difference seen
    is 1.6e-3); fuse_step fed the same tri block:
    identical direction-A and direction-B indices; unpack_tri_fuse splits
    both buffers alike."""
    for (args, _, want_tri) in rec["tri"]:
        got_tri = mapper_fused.tri_step(*map(to_t, args)).numpy()
        np.testing.assert_array_equal(got_tri[:, :3], want_tri[:, :3])
        acc = want_tri[:, 0] > 0.5
        np.testing.assert_allclose(got_tri[acc, 3:], want_tri[acc, 3:],
                                   rtol=3e-3, atol=3e-3)
    for (args, _, want) in rec["fuse"]:
        tri = np.asarray(args[0])
        N1 = tri.shape[0]
        T = np.asarray(args[16]).shape[0]
        PB = np.asarray(args[30]).shape[0]
        got = mapper_fused.fuse_step(*map(to_t, args)).numpy()
        g = mapper_fused.unpack_tri_fuse(got, N1, T, 2 * N1, PB)
        w = jmf.unpack_tri_fuse(np.asarray(want), N1, T, 2 * N1, PB)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        assert (g[1] >= 0).sum() > 0 and (g[2] >= 0).sum() > 0
        assert mapper_fused.unpack_tri_fuse(got, N1, T, 2 * N1, PB,
                                            do_fuse=False)[1] is None
