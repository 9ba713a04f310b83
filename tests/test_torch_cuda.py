"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the relocalization and loop-closing paths' torch code on the card
against the CPU, with one loop closed on the card.

Marked `cuda`: they skip without a GPU (a CUDA kernel has no CPU mode).
Run them on a machine with an NVIDIA GPU and nvcc (--noconftest: the
shared conftest imports jax, which that machine need not have):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from orb_slam_system_tpu_torch.ops import brief, fast, patches
from orb_slam_system_tpu_torch.ops.orientation import angles_from_moments

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("h,w", [(480, 640), (161, 214), (64, 70)])
def test_fast_score_nms_bit_exact(dev, h, w, rng):
    img = torch.from_numpy(rng.integers(0, 256, (2, h, w)).astype(np.float32)).to(dev)
    got = fast.fast_score_nms(img, 19)
    want = fast.nms3x3(fast.fast_score_map(img, 19))
    assert torch.equal(got, want)


def _rendered_pyramid(dev, h=480, w=640):
    from orb_slam_system_tpu_torch.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu_torch.ops.pyramid import build_pyramid
    K = np.array([[520.0, 0, w / 2], [0, 520.0, h / 2], [0, 0, 1]])
    r = PlanarSceneRenderer(K, w, h, texture=make_texture(2048, 8, 7),
                            tex_scale=440.0)
    img = np.clip(r.render(orbit_trajectory(2, 0.35, -2.0, 0.3)[1]), 0, 255)
    img = torch.from_numpy(img.astype(np.uint8).astype(np.float32)).to(dev)
    return build_pyramid(img[None], 8, 1.2)


@pytest.mark.parametrize("case", ["pyramid_640x480_b1", "odd_sizes_b2"])
def test_fast_score_nms_levels_bit_exact(dev, rng, case):
    """One launch over all levels equals the plain version level by level:
    the 8 levels of a rendered 640x480 frame, and odd sizes at B=2."""
    if case == "pyramid_640x480_b1":
        levels = _rendered_pyramid(dev)
    else:
        levels = [torch.from_numpy(rng.integers(0, 256, (2, h, w))
                                   .astype(np.float32)).to(dev)
                  for h, w in [(161, 214), (64, 70), (33, 97), (200, 41), (40, 40)]]
    got = fast.fast_score_nms_levels(levels, 19)
    torch.cuda.synchronize()
    assert len(got) == len(levels)
    for lvl, g in zip(levels, got):
        assert g.shape == lvl.shape and g.is_contiguous()
        assert torch.equal(g, fast.nms3x3(fast.fast_score_map(lvl, 19)))


def test_fast_score_nms_levels_rejects(dev):
    """Mixed batch sizes, more levels than the table holds, and a CPU level
    among CUDA ones raise."""
    a = torch.zeros((1, 64, 64), device=dev)
    with pytest.raises(ValueError):
        fast.fast_score_nms_levels([a, torch.zeros((2, 64, 64), device=dev)], 19)
    with pytest.raises(ValueError):
        fast.fast_score_nms_levels([a] * (fast.MAX_LEVELS + 1), 19)
    with pytest.raises(ValueError):
        fast.fast_score_nms_levels([a, torch.zeros((1, 64, 64))], 19)


def test_extractor_launches_kernel_a_once(dev):
    """ORBExtractor runs kernel A once per call, for all its levels."""
    from orb_slam_system_tpu_torch.config import ORBConfig
    from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
    from orb_slam_system_tpu_torch.utils import kernels
    img = _rendered_pyramid(dev)[0]
    ex = ORBExtractor(ORBConfig(n_features=1000), 480, 640)
    ex(img)
    kernels.reset_launch_counts()
    ex(img)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_score_nms"] == 1


def test_gather_blur_moments(dev, rng):
    canvas = torch.from_numpy(rng.uniform(0, 255, (2, 300, 200)).astype(np.float32)).to(dev)
    xy = torch.from_numpy(np.stack([rng.integers(-5, 210, (2, 300)),
                                    rng.integers(-5, 310, (2, 300))],
                                   -1).astype(np.int32)).to(dev)
    kb, km = patches.gather_blur_moments(canvas, xy, 21)
    pb, pm = patches.gather_blur_moments_plain(canvas, xy, 21)
    assert torch.equal(kb, pb)
    assert float((km - pm).abs().max()) <= 0.5


@pytest.mark.parametrize("n", [1024, 2048, 333, 0])
def test_gather_blur_modes_match_plain(dev, rng, n):
    """Kernel B's two modes at B = 2 with clipped edge keypoints. Blur mode:
    bit-exact against gather_blur_moments_plain, moments within 0.5.
    Describe mode: its moments equal blur mode's bit for bit, its angle is
    angles_from_moments of them, its descriptors are brief_pack_plain of
    the plain blur at that angle. N = 0 launches nothing."""
    from orb_slam_system_tpu_torch.utils import kernels
    canvas = torch.from_numpy(rng.uniform(0, 255, (2, 300, 200)).astype(np.float32)).to(dev)
    xy = np.stack([rng.integers(-5, 210, (2, n)), rng.integers(-5, 310, (2, n))],
                  -1).astype(np.int32)
    if n:
        xy[:, :4] = [[0, 0], [199, 299], [-30, 310], [230, 1]]
    xy = torch.from_numpy(xy).to(dev)
    kernels.reset_launch_counts()
    kb, km = patches.gather_blur_moments(canvas, xy, 21)
    dm, da, dd = patches.gather_blur_describe(canvas, xy, 21)
    torch.cuda.synchronize()
    launched = int(n > 0)
    assert kernels.LAUNCHES["gather_blur_moments"] == launched
    assert kernels.LAUNCHES["gather_blur_describe"] == launched
    pb, pm = patches.gather_blur_moments_plain(canvas, xy, 21)
    assert kb.shape == pb.shape and dd.shape == (2, n, 8)
    assert torch.equal(kb, pb)
    assert n == 0 or float((km - pm).abs().max()) <= 0.5
    assert torch.equal(dm, km)
    assert torch.equal(da, angles_from_moments(km))
    assert torch.equal(dd, brief.brief_pack_plain(pb, da))


def test_fused_route_launches_describe_once(dev):
    """ORBExtractor's fused route runs kernel B's describe mode once per
    call and neither its blur mode nor kernel C."""
    from orb_slam_system_tpu_torch.config import ORBConfig
    from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
    from orb_slam_system_tpu_torch.utils import kernels
    img = _rendered_pyramid(dev)[0]
    ex = ORBExtractor(ORBConfig(n_features=1000), 480, 640)
    ex(img)
    kernels.reset_launch_counts()
    ex(img)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"fast_score_nms": 1, "gather_blur_moments": 0,
                                "gather_blur_describe": 1, "brief_pack": 0,
                                "gather_patches": 0}


def test_brief_pack_bit_exact(dev, rng):
    blurred = torch.from_numpy(rng.uniform(0, 255, (1, 777, 37, 37)).astype(np.float32)).to(dev)
    ang = angles_from_moments(torch.from_numpy(
        rng.normal(size=(1, 777, 2)).astype(np.float32)).to(dev))
    assert torch.equal(brief.brief_pack(blurred, ang),
                       brief.brief_pack_plain(blurred, ang))


def test_wrappers_check_arguments(dev):
    with pytest.raises(TypeError):
        fast.fast_score_nms(torch.zeros((1, 64, 64), dtype=torch.float64,
                                        device=dev), 19)
    with pytest.raises(ValueError):
        fast.fast_score_nms(torch.zeros((1, 64, 128), device=dev)[:, :, ::2], 19)


@pytest.mark.parametrize("radius", [21, 5, 0])
@pytest.mark.parametrize("n", [2048, 333])
def test_gather_patches_bit_exact(dev, rng, radius, n):
    """Kernel D against its plain version, including clipped edge
    keypoints, at the extractor's radius and two others, with N a multiple
    of 4 and not."""
    canvas = torch.from_numpy(rng.uniform(0, 255, (2, 300, 200)).astype(np.float32)).to(dev)
    xy = np.stack([rng.integers(-5, 210, (2, n)), rng.integers(-5, 310, (2, n))],
                  -1).astype(np.int32)
    xy[:, :4] = [[0, 0], [199, 299], [-30, 310], [230, 1]]
    xy = torch.from_numpy(xy).to(dev)
    assert torch.equal(patches.gather_patches(canvas, xy, radius),
                       patches.gather_patches_plain(canvas, xy, radius))


def test_gather_patches_no_keypoints(dev):
    """N = 0: an empty [B, 0, P, P] result and no launch."""
    from orb_slam_system_tpu_torch.utils import kernels
    kernels.reset_launch_counts()
    out = patches.gather_patches(torch.zeros((2, 64, 64), device=dev),
                                 torch.zeros((2, 0, 2), dtype=torch.int32,
                                             device=dev), 21)
    assert tuple(out.shape) == (2, 0, 43, 43)
    assert kernels.LAUNCHES["gather_patches"] == 0


def test_unfused_route_matches_fused_route(dev):
    """The extractor's unfused route (kernel D + plain moments and blur)
    against the fused route (kernel B) on the card: identical keypoints,
    descriptor bits equal except at counted angle-bin flips (<= 1%)."""
    from orb_slam_system_tpu_torch.config import ORBConfig
    from orb_slam_system_tpu_torch.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu_torch.ops.brief import _angle_bins
    from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor

    K = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]])
    r = PlanarSceneRenderer(K, 640, 480, texture=make_texture(2048, 8, 7),
                            tex_scale=440.0)
    img = torch.from_numpy(r.render(orbit_trajectory(2, 0.35, -2.0, 0.3)[1])
                           .astype(np.float32)).to(dev)[None]
    cfg = ORBConfig(n_features=2000)
    fu = ORBExtractor(cfg, 480, 640, fused_gather=True)(img)
    un = ORBExtractor(cfg, 480, 640, fused_gather=False)(img)
    assert torch.equal(fu.xy, un.xy) and torch.equal(fu.valid, un.valid)
    flips = (_angle_bins(fu.angle) != _angle_bins(un.angle)) & fu.valid
    assert int(flips.sum()) <= 0.01 * int(fu.valid.sum())
    diff = (fu.desc != un.desc).any(-1) & fu.valid
    assert not bool((diff & ~flips).any())


def _clustered_descriptors(rng, n, n_centres=60, flips=20):
    """u32[n,8] descriptors scattered around random centres."""
    centres = rng.integers(0, 2 ** 32, size=(n_centres, 8), dtype=np.uint32)
    bits = np.unpackbits(centres[rng.integers(0, n_centres, n)].view(np.uint8),
                         axis=1)
    for i in range(n):
        bits[i, rng.choice(256, flips, replace=False)] ^= 1
    return np.packbits(bits, axis=1).view(np.uint32)


@pytest.fixture(scope="module")
def vocab_trees():
    from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary
    D = _clustered_descriptors(np.random.default_rng(0), 2500)
    return {"self_trained": Vocabulary.build(D, k=10, L=3, seed=0),
            "k4_L6": Vocabulary.build(D, k=4, L=6, seed=1)}


@pytest.mark.parametrize("n", [1000, 0, 2048])
@pytest.mark.parametrize("tree", ["self_trained", "k4_L6"])
def test_vocab_descent_bit_equal(dev, vocab_trees, tree, n):
    """The torch descent on the card equals the numpy descent (word ids,
    weight bits, node ids), some slots invalid."""
    voc = vocab_trees[tree]
    rng = np.random.default_rng(n)
    D = _clustered_descriptors(rng, n)
    valid = rng.uniform(size=n) < 0.9
    got = voc.transform_device(torch.from_numpy(D.view(np.int32)).to(dev),
                               torch.from_numpy(valid).to(dev))
    want = voc.transform(D, valid)
    for g, w in zip(got, want):
        assert g.is_cuda
        np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                      w.view(np.int32))


def test_epnp_ransac_batch_matches_cpu(dev):
    """epnp_ransac_batch on the card against the port on the CPU, C = 3
    (good, 60 wrong associations, garbage): ok equal, inlier masks equal
    except <= 1% of N, rotation within 0.05 deg and translation within 1e-3
    (tests/test_torch_pnp.py's tolerances against JAX)."""
    from orb_slam_system_tpu_torch.solvers import pnp
    from orb_slam_system_tpu_torch.utils.lie import so3_exp
    rng = np.random.default_rng(0)
    N = 1024
    X = rng.uniform(-3, 3, size=(N, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(4, 10, size=N)
    R = so3_exp(torch.from_numpy((rng.normal(size=3) * 0.3).astype(np.float32))).numpy()
    t = (rng.normal(size=3) * 0.5).astype(np.float32)
    Xc = X @ R.T + t
    uv = (Xc[:, :2] / Xc[:, 2:3] * 500.0 + [320.0, 240.0]
          + rng.normal(size=(N, 2)) * 0.3).astype(np.float32)
    X_out = X.copy()
    X_out[:60] = rng.uniform(-3, 3, size=(60, 3)) + [0, 0, 7]
    X_bad = rng.uniform(-3, 3, size=(N, 3)).astype(np.float32) + [0, 0, 6]
    Xs = np.stack([X, X_out, X_bad]).astype(np.float32)
    valid = rng.uniform(size=(3, N)) < 0.9
    args = [torch.from_numpy(a) for a in (
        Xs, uv, np.ones(N, np.float32), valid,
        pnp.make_pnp_sample_sets(N, 300, 0).astype(np.int64))]
    cam = (500.0, 500.0, 320.0, 240.0)
    ok_c, T_c, inl_c, _ = pnp.epnp_ransac_batch(*args, *cam)
    ok_g, T_g, inl_g, _ = (x.cpu() for x in pnp.epnp_ransac_batch(
        *(a.to(dev) for a in args), *cam))
    assert ok_c.tolist() == ok_g.tolist() == [True, True, False]
    for c in range(2):
        assert int((inl_c[c] != inl_g[c]).sum()) <= 0.01 * N
        # The angle from the skew part (arccos of the trace of two float32
        # rotations cannot resolve 0.05 deg).
        M = (T_c[c, :3, :3].double() @ T_g[c, :3, :3].double().T).numpy()
        s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                            M[1, 0] - M[0, 1]])
        assert np.degrees(np.arctan2(0.5 * s, 0.5 * (np.trace(M) - 1.0))) < 0.05
        assert float((T_c[c, :3, 3] - T_g[c, :3, 3]).abs().max()) < 1e-3


def test_forced_relocalization_640x480(dev):
    """A 40-frame 640x480 System run on the card self-trains its vocabulary;
    forced LOST, a view of frame 20 relocalizes to OK."""
    from orb_slam_system_tpu_torch.config import TrackingState
    from orb_slam_system_tpu_torch.drivers import mono_synthetic
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        slam, _ = mono_synthetic.run(40, out, 1000, 640, 480, device="cuda",
                                     verbose=False)
    assert slam.place_rec.ready
    cfg = mono_synthetic.make_config(640, 480, 1000)
    poses = mono_synthetic.orbit_trajectory(40, radius=0.35, depth=-2.0, tilt=0.3)
    img = mono_synthetic.make_renderer(cfg).render(poses[20])
    slam.tracker.state = TrackingState.LOST
    slam.tracker.velocity = None
    assert slam.track_monocular(img, 100.0) is not None
    assert slam.get_tracking_state() == TrackingState.OK
    assert slam.tracker.reloc_stats["ok"] == 1


# ---- loop closing: the solvers on the card against the CPU ------------------------


def _to(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _rot_deg(Ra, Rb):
    M = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.degrees(np.arctan2(0.5 * s, 0.5 * (np.trace(M) - 1.0))))


def _sim3_pairs(rng, C=3, N=96, n_out=20):
    """C matched point sets related by a Sim3 each, n_out scrambled rows."""
    from orb_slam_system_tpu_torch.utils.lie import so3_exp
    out = []
    for c in range(C):
        P2 = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
        P2[:, 2] = rng.uniform(4, 8, size=N)
        R = so3_exp(torch.from_numpy((rng.normal(size=3) * 0.1).astype(np.float32))).numpy()
        P1 = (1.2 + 0.1 * c) * (P2 @ R.T) + np.array([0.4, -0.2, 0.3], np.float32)
        uv1 = (P1[:, :2] / P1[:, 2:3] * 500.0 + [320.0, 240.0]).astype(np.float32)
        uv2 = (P2[:, :2] / P2[:, 2:3] * 500.0 + [320.0, 240.0]).astype(np.float32)
        idx = rng.choice(N, size=n_out, replace=False)
        P2[idx] = P2[idx][::-1] + rng.normal(size=(n_out, 3)).astype(np.float32)
        out.append((P1.astype(np.float32), P2, uv1, uv2))
    return [np.stack([o[k] for o in out]) for k in range(4)]


def test_sim3_ransac_and_optimize_sim3_match_cpu(dev, rng):
    """sim3_ransac_batch (3 pairs) and optimize_sim3 on the card against the
    CPU: ok and inlier masks equal, s and t within 1e-3, R within 0.05 deg
    (tests/test_torch_lie_sim3.py's tolerances against JAX)."""
    from orb_slam_system_tpu_torch.solvers import pose_graph, sim3
    P1, P2, uv1, uv2 = _sim3_pairs(rng)
    C, N = P1.shape[:2]
    m = np.full((C, N), 9.21, np.float32)
    valid = np.ones((C, N), bool)
    sets = sim3.make_sim3_sample_sets(128, 300, 0).astype(np.int64)
    cam = (500.0, 500.0, 320.0, 240.0)
    args = (P1, P2, uv1, uv2, m, m, valid, sets)
    cpu = sim3.sim3_ransac_batch(*_to("cpu", *args), *cam).numpy()
    gpu = sim3.sim3_ransac_batch(*_to(dev, *args), *cam).cpu().numpy()
    assert cpu[:, 0].all()
    np.testing.assert_array_equal(gpu[:, 0], cpu[:, 0])
    np.testing.assert_array_equal(gpu[:, 14:], cpu[:, 14:])
    np.testing.assert_allclose(gpu[:, [1, 11, 12, 13]], cpu[:, [1, 11, 12, 13]],
                               atol=1e-3)
    for c in range(C):
        assert _rot_deg(gpu[c, 2:11].reshape(3, 3), cpu[c, 2:11].reshape(3, 3)) < 0.05
    one = np.ones(N, np.float32)
    oargs = (np.float32(cpu[0, 1] * 1.02), cpu[0, 2:11].reshape(3, 3).copy(),
             cpu[0, 11:14] + 0.01, P1[0], P2[0], uv1[0], uv2[0], one, one,
             valid[0])
    n_c, s_c, R_c, t_c, inl_c = pose_graph.optimize_sim3(*_to("cpu", *oargs), *cam)
    n_g, s_g, R_g, t_g, inl_g = (x.cpu() for x in pose_graph.optimize_sim3(
        *_to(dev, *oargs), *cam))
    assert int(n_g) == int(n_c) >= N - 20
    assert torch.equal(inl_g, inl_c)
    assert abs(float(s_g) - float(s_c)) < 1e-3
    assert float((t_g - t_c).abs().max()) < 1e-3
    assert _rot_deg(R_g.numpy(), R_c.numpy()) < 0.05


def test_essential_graph_matches_cpu(dev, rng):
    """optimize_essential_graph on a drifted 30-keyframe circle with
    odometry edges and one loop edge: card against CPU within 1e-3 / 0.05
    deg."""
    from orb_slam_system_tpu_torch.solvers import pose_graph
    from orb_slam_system_tpu_torch.utils.lie import se3_exp
    K = 30

    def pose(k):
        a = 2 * np.pi * k / K
        return se3_exp(torch.tensor([0.5 * np.sin(a), 0.0, 0.5 * (1 - np.cos(a)),
                                     0.0, a, 0.0], dtype=torch.float32)).numpy()
    T_true = [pose(k) for k in range(K)]
    T_est = [T_true[0]]
    for k in range(1, K):
        noise = se3_exp(torch.from_numpy((rng.normal(size=6) * 0.02).astype(np.float32)))
        T_est.append(noise.numpy() @ T_true[k] @ np.linalg.inv(T_true[k - 1]) @ T_est[-1])
    edges = [(k, k + 1, T_est[k], T_est[k + 1]) for k in range(K - 1)]
    edges.append((K - 1, 0, T_true[K - 1], T_true[0]))
    rel = [Tj @ np.linalg.inv(Ti) for _, _, Ti, Tj in edges]
    fixed = np.arange(K) == 0
    args = (np.stack([T[:3, :3] for T in T_est]).astype(np.float32),
            np.stack([T[:3, 3] for T in T_est]).astype(np.float32),
            np.ones(K, np.float32), fixed, np.ones(K, bool),
            np.asarray([e[0] for e in edges], np.int64),
            np.asarray([e[1] for e in edges], np.int64),
            np.stack([r[:3, :3] for r in rel]).astype(np.float32),
            np.stack([r[:3, 3] for r in rel]).astype(np.float32),
            np.ones(len(edges), np.float32), np.ones(len(edges), bool))
    Rc, tc, sc = pose_graph.optimize_essential_graph(*_to("cpu", *args))
    Rg, tg, sg = (x.cpu() for x in pose_graph.optimize_essential_graph(*_to(dev, *args)))
    assert float((tg - tc).abs().max()) < 1e-3
    assert float((sg - sc).abs().max()) < 1e-3
    assert max(_rot_deg(Rg[k].numpy(), Rc[k].numpy()) for k in range(K)) < 0.05


def test_bundle_adjust_cg_matches_cpu(dev, rng):
    """bundle_adjust_cg over 6 cameras x 200 points: card against CPU,
    poses within 1e-4, points within 1e-4 of their coordinate (at least
    1; float32 sums in another order, points up to 9 units deep)."""
    from orb_slam_system_tpu_torch.solvers.local_ba import (BAProblem,
                                                           bundle_adjust_cg)
    from orb_slam_system_tpu_torch.utils.lie import se3_exp
    C, P = 6, 200
    X = rng.uniform(-3, 3, size=(P, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(5, 9, size=P)
    Tcw = se3_exp(torch.tensor([[0.3 * c, 0, 0, 0, 0.01 * c, 0] for c in range(C)],
                               dtype=torch.float32)).numpy()
    e_cam = np.repeat(np.arange(C), P)
    e_pt = np.tile(np.arange(P), C)
    Xc = np.einsum("cij,pj->cpi", Tcw[:, :3, :3], X) + Tcw[:, None, :3, 3]
    uv = (Xc[..., :2] / Xc[..., 2:] * 500.0 + [320.0, 240.0]).reshape(-1, 2)
    uv = (uv + rng.normal(size=uv.shape) * 0.3).astype(np.float32)
    T0 = Tcw.copy()
    T0[1:] = se3_exp(torch.from_numpy((rng.normal(size=(C - 1, 6)) * 0.02)
                                      .astype(np.float32))).numpy() @ Tcw[1:]
    X0 = (X + rng.normal(size=X.shape) * 0.05).astype(np.float32)
    E = len(e_cam)

    def prob(d):
        a = _to(d, T0, np.arange(C) == 0, np.ones(C, bool), X0, np.ones(P, bool),
                e_cam, e_pt, uv, np.ones(E, np.float32), np.ones(E, bool))
        return BAProblem(*a)
    cam = (500.0, 500.0, 320.0, 240.0)
    Tc, Xc_ = bundle_adjust_cg(prob("cpu"), *cam, n_iters=4, cg_iters=30)
    Tg, Xg = (x.cpu() for x in bundle_adjust_cg(prob(dev), *cam, n_iters=4,
                                                 cg_iters=30))
    assert float((Tg - Tc).abs().max()) < 1e-4
    assert float(((Xg - Xc_).abs() / Xc_.abs().clamp_min(1.0)).max()) < 1e-4


def test_frame_builder_takes_any_layout(dev):
    """A column-major image (what np.apply_along_axis over axis 0 returns)
    builds the same frame as its row-major copy."""
    from orb_slam_system_tpu_torch.drivers import mono_synthetic
    from orb_slam_system_tpu_torch.models.frame import FrameBuilder
    cfg = mono_synthetic.make_config(320, 240, 400)
    img = mono_synthetic.render_sequence(cfg, 2)[0][1]
    fb = FrameBuilder(cfg, dev)
    got = fb.build(np.asfortranarray(img), 0.0).packed
    want = fb.build(np.ascontiguousarray(img), 0.0).packed
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_loop_closes_on_the_card_320x240(dev):
    """The 90-frame degraded circle at 320x240 through drivers/loop_synthetic
    on the card closes its loop (tests/test_e2e_loop.py's bars: >= 1 loop,
    >= 80 of 90 frames tracked, ATE < 10 cm)."""
    from orb_slam_system_tpu_torch.drivers import loop_synthetic
    slam, rmse, n_tracked = loop_synthetic.run(90, device="cuda", sync_gba=True,
                                               verbose=False)
    assert slam.loop_closer.n_loops_closed >= 1
    assert n_tracked >= 80
    assert rmse < 0.10
    assert slam.tracker.epoch_violations == 0
