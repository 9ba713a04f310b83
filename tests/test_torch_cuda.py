"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the relocalization, loop-closing, stereo and chain-step torch code on
the card against the CPU (the chain step under CUDA's sync debug mode),
with one loop closed, one stereo run and one async + pipelined monocular
run tracked on the card; the multi-sequence mode's batch-5 pack and
batched front-end step on the card; the sharded solvers on NCCL ranks and
the warm pass on the card; the pose LM kernel against the eager LM on the
card.

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
                                "gather_patches": 0, "pose_lm": 0}


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


def _kitti_pair():
    """A rectified KITTI 00-02 pair (1241x376, bf 386.1448, 2000 features in
    2048 slots) of the textured plane at texture scale 440, frame 0 of the
    orbit, and its settings."""
    import os
    from orb_slam_system_tpu_torch.config import Sensor, load_settings
    from orb_slam_system_tpu_torch.drivers.stereo_synthetic import render_pairs
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_settings(os.path.join(root, "examples", "settings",
                                     "kitti00-02.yaml"), Sensor.STEREO)
    pairs, _ = render_pairs(cfg, 1, tex_scale=440.0)
    return cfg, pairs[0]


def test_kernels_at_batch2_on_a_kitti_pair(dev):
    """Kernels A and B (describe mode) at the stereo frame's shape: the
    pair's 8 levels at B = 2 in one launch of A, bit-exact; B's describe
    mode over the pair's 2 x 2048 keypoints against its plain checks (as
    test_gather_blur_modes_match_plain), one launch each per frame."""
    from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
    from orb_slam_system_tpu_torch.utils import kernels
    cfg, (left, right) = _kitti_pair()
    ex = ORBExtractor(cfg.orb, cfg.camera.height, cfg.camera.width)
    assert ex.n_slots == 2048
    img = torch.from_numpy(np.stack([left, right])).to(dev)
    sel, canvas, xy, levels = ex.detect(img)
    assert levels[0].shape == (2, 376, 1241)
    for lvl, got in zip(levels, fast.fast_score_nms_levels(levels, 19)):
        assert torch.equal(got, fast.nms3x3(fast.fast_score_map(lvl, 19)))
    kernels.reset_launch_counts()
    dm, da, dd = patches.gather_blur_describe(canvas, xy, 21)
    ex.extract(img)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather_blur_describe"] == 2
    assert kernels.LAUNCHES["fast_score_nms"] == 1
    kb, km = patches.gather_blur_moments(canvas, xy, 21)
    pb, _ = patches.gather_blur_moments_plain(canvas, xy, 21)
    assert torch.equal(kb, pb)
    assert torch.equal(dm, km)
    assert torch.equal(da, angles_from_moments(km))
    assert torch.equal(dd, brief.brief_pack_plain(pb, da))


def test_stereo_match_on_the_card_matches_cpu_kitti(dev):
    """stereo_match on the card against the CPU on the same inputs (the
    card's extraction of a KITTI-width pair, 2048 slots): matched masks
    equal on all but 0.2% of the slots (the SAD sums run in another order
    on the card, which can move a near-tie of the slide or a match at the
    median filter's edge), u_right within 1e-3 px and depth within 1e-4 m
    where both matched."""
    from orb_slam_system_tpu_torch.models.frame import FrameBuilder
    from orb_slam_system_tpu_torch.ops.stereo import stereo_match
    cfg, (left, right) = _kitti_pair()
    fb = FrameBuilder(cfg, dev)
    c = cfg.camera
    fs, levels = fb.extractor.extract(
        torch.stack([fb._upload(left), fb._upload(right)]))

    def match(d):
        lv = [l.to(d) for l in levels]
        sides = [a.to(d) for b in (0, 1) for a in (fs.xy[b], fs.octave[b],
                                                    fs.desc[b], fs.valid[b])]
        return [a.cpu().numpy() for a in stereo_match(
            [l[0] for l in lv], [l[1] for l in lv], *sides,
            fb._scales_dev.to(d), c.bf, 0.0, c.fx)]

    gu, gd = match(dev)
    cu, cd = match("cpu")
    gm, cm = gu >= 0, cu >= 0
    assert cm.sum() > 1000
    assert (gm != cm).sum() <= 0.002 * len(cm)
    both = gm & cm
    np.testing.assert_allclose(gu[both], cu[both], atol=1e-3)
    np.testing.assert_allclose(gd[both], cd[both], atol=1e-4)


def test_stereo_system_on_the_card_320x240(dev):
    """drivers/stereo_synthetic at tests/test_e2e_stereo.py's settings on
    the card passes that file's bars."""
    from orb_slam_system_tpu_torch.config import TrackingState
    from orb_slam_system_tpu_torch.drivers import stereo_synthetic
    slam, rmse, span, span_gt = stereo_synthetic.run(
        18, None, 400, device="cuda", verbose=False)
    assert slam.get_tracking_state() == TrackingState.OK
    kf0 = slam.arena.kfs[slam.arena.kf_origin_id]
    assert kf0.frame_id == 0
    assert rmse < 0.12
    assert abs(span - span_gt) / span_gt < 0.15
    ur = kf0.feats.u_right
    disp = kf0.feats.xy_und[ur >= 0, 0] - ur[ur >= 0]
    assert len(disp) > 150 and (disp > 0).all() and disp.max() < slam.cfg.camera.fx


def _chain_case(rgbd: bool):
    """A chain step's inputs, as numpy: two RGB-D (18-column) or monocular
    frames of the 320x240 orbit built on the CPU, a 512-point block seeded
    from frame 0's depths, an association into a permuted previous block
    with -1s, a remap with dropped rows, and a pose state a little off
    SO(3). Returns (cfg, builder, inputs)."""
    from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig,
                                                  Sensor, SlamConfig)
    from orb_slam_system_tpu_torch.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu_torch.models.frame import FrameBuilder
    from orb_slam_system_tpu_torch.models.tracking import seed_map_from_depth
    cam = CameraConfig(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320,
                       height=240, bf=20.8 if rgbd else 0.0)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=400),
                     sensor=Sensor.RGBD if rgbd else Sensor.MONOCULAR,
                     th_depth=2.05, depth_map_factor=1.0)
    r = PlanarSceneRenderer(cam.K, 320, 240, texture=make_texture(2048, 8, 7),
                            tex_scale=220.0)
    poses = orbit_trajectory(30, radius=0.35, depth=-2.0, tilt=0.3)[:2]
    fb = FrameBuilder(cfg, "cpu")
    imgs = [np.clip(r.render(T), 0, 255).astype(np.uint8) for T in poses]
    depths = [r.render_depth(T).astype(np.float32) for T in poses]
    packed = [(fb.build_rgbd(i, d, 0.0) if rgbd else fb.build(i, 0.0)).packed
              for i, d in zip(imgs, depths)]
    feats0 = FrameBuilder._unpack_feats(packed[0].numpy())
    lm, mp_ids = seed_map_from_depth(feats0, poses[0].astype(np.float32),
                                     depths[0], cam, fb.scale_factors, 512)
    rng = np.random.default_rng(3)
    k = len(lm.ids)
    perm = rng.permutation(k)
    remap = np.full(512, -1, np.int64)
    remap[:k] = perm
    remap[rng.random(512) < 0.05] = -1
    assoc = np.where(mp_ids >= 0, np.argsort(perm)[np.maximum(mp_ids, 0)], -1)
    assoc[rng.random(len(assoc)) < 0.1] = -1
    T0, T1 = (p.astype(np.float64) for p in poses)
    T_last = T0.astype(np.float32)
    T_last[:3, :3] *= np.float32(1.002)
    T_prev = (np.linalg.inv(T1 @ np.linalg.inv(T0)) @ T0).astype(np.float32)
    block = (lm.pos, lm.normal, lm.mind, lm.maxd, lm.desc, lm.valid)
    return cfg, fb, (T_prev, T_last, assoc, remap, packed, block)


@pytest.mark.parametrize("rgbd", [False, True])
def test_chain_step_on_the_card_matches_cpu(dev, rgbd):
    """TrackPrograms.chain_step on the card against the CPU on the same
    inputs, with CUDA's sync debug mode set to "error" around the card's
    step (no read back to the host, no blocking upload): pose within 1e-3,
    counts within 3% (the pose LM reclassifies edges whose chi2 sits near
    its threshold where float32 sums run in another order), association,
    visible and already-local rows equal on >= 99%."""
    from orb_slam_system_tpu_torch.models.track_device import TrackPrograms
    from orb_slam_system_tpu_torch.utils.interop import (
        local_block_from_numpy, to_device)
    cfg, fb, (T_prev, T_last, assoc, remap, packed, block) = _chain_case(rgbd)
    outs = []
    for d in ("cpu", dev):
        prog = TrackPrograms(cfg, fb.extractor.n_slots, 512, fb.bounds, d)
        args = [to_device(a, d, non_blocking=True)
                for a in (T_prev, T_last, assoc, remap)]
        args += [p.to(d) for p in packed]
        args.append(local_block_from_numpy(*block, d, non_blocking=True))
        if d != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = prog.chain_step(*args)[3]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs.append(prog.decode_chain_out(out.cpu().numpy()))
    (cT, ca, cv, cal, *cc), (gT, ga, gv, gal, *gc) = outs
    assert cc[1] >= 100 and cc[3] >= 100, cc
    np.testing.assert_allclose(gT, cT, rtol=0, atol=1e-3)
    for c, g in zip(cc[:4], gc[:4]):
        assert abs(c - g) <= 0.03 * max(c, 1), (cc, gc)
    assert (ga == ca).mean() >= 0.99
    assert (gv == cv).mean() >= 0.99 and (gal == cal).mean() >= 0.99
    if rgbd:
        assert all(abs(c - g) <= 0.03 * max(c, 1) for c, g in zip(cc[4], gc[4]))


def test_chain_fetch_matches_blocking_copy(dev):
    """ChainFetch's pinned copy behind queued work, waited on through its
    event, returns what a blocking .cpu() of the same tensor returns."""
    from orb_slam_system_tpu_torch.models.track_device import ChainFetch
    fetch = ChainFetch(1 << 20, 3, dev)
    x = torch.randn(1 << 20, device=dev)
    for i in range(5):
        torch.cuda._sleep(2_000_000)          # work queued before the copy
        y = x * (i + 1) + 0.5
        ticket = fetch.issue(y)
        assert ticket[0].is_pinned()
        got = ChainFetch.wait(ticket).copy()
        assert np.array_equal(got, y.cpu().numpy())


def test_async_pipelined_system_on_the_card_320x240(dev):
    """drivers/mono_synthetic with the async mapper and
    track_monocular_pipelined on the card, 30 frames of the 320x240 orbit:
    one record per frame in order, >= 28 OK, >= 10 chain accepts, ATE
    < 3 cm, a clean shutdown."""
    from orb_slam_system_tpu_torch.config import TrackingState
    from orb_slam_system_tpu_torch.drivers import mono_synthetic
    slam, rmse = mono_synthetic.run(30, None, 400, device="cuda",
                                    verbose=False, pipelined=True,
                                    async_mapping=True)
    recs = slam.telemetry.records
    assert [r["t"] for r in recs] == [i / 30.0 for i in range(30)]
    assert sum(r["state"] == int(TrackingState.OK) for r in recs) >= 28
    assert slam.tracker.chain_stats["accept"] >= 10
    assert rmse < 0.03
    assert slam.local_mapper._thread is None
    assert slam.local_mapper.worker_errors == 0
    assert slam.tracker.epoch_violations == 0


def test_batched_pack_on_the_card_equals_single_packs(dev):
    """FrameBuilder.extract_packed_batch at batch 5 on the card (752x480,
    1000 features: the multi-sequence phase's shape) equals five
    single-image packs bit for bit, in one launch of kernel A and one of
    kernel B's describe mode."""
    from orb_slam_system_tpu_torch.config import ORBConfig, SlamConfig
    from orb_slam_system_tpu_torch.drivers import multiseq_throughput
    from orb_slam_system_tpu_torch.models.frame import FrameBuilder
    from orb_slam_system_tpu_torch.utils import kernels
    cam = multiseq_throughput.default_camera(752, 480)
    renderers, trajs = multiseq_throughput.sequence_scenes(5, 2, cam)
    imgs = np.stack([r.render(t[1]) for r, t in zip(renderers, trajs)])
    fb = FrameBuilder(SlamConfig(camera=cam, orb=ORBConfig(n_features=1000)),
                      dev)
    kernels.reset_launch_counts()
    packed = fb.extract_packed_batch(imgs)
    assert kernels.LAUNCHES["fast_score_nms"] == 1
    assert kernels.LAUNCHES["gather_blur_describe"] == 1
    assert packed.shape == (5, 1024, 16)
    for s in range(5):
        one = fb.extract_packed(imgs[s])
        assert torch.equal(packed[s].view(torch.int32), one.view(torch.int32))


def test_frontend_step_on_the_card_matches_cpu(dev):
    """parallel/multiseq's step on the card against the same step on the
    CPU: on its example arguments (totals equal, poses within 1e-3), and on
    a tracked state of rendered frames (the previous descriptors the
    frame's own, the points back-projected 4 m out from a camera 2 cm off;
    totals within 1%, poses within 1e-3, rotations orthonormal)."""
    from orb_slam_system_tpu_torch.config import ORBConfig
    from orb_slam_system_tpu_torch.drivers import multiseq_throughput
    from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
    from orb_slam_system_tpu_torch.parallel.multiseq import make_multiseq_step
    H, W, S = 240, 320, 4
    step, args = make_multiseq_step(H, W, 512, 4, S, device=dev)
    cpu_step, cargs = make_multiseq_step(H, W, 512, 4, S, device="cpu")
    T, n_in, n_match = step(*args)
    cT, c_in, c_match = cpu_step(*cargs)
    assert (int(n_match), int(n_in)) == (int(c_match), int(c_in))
    assert float((T.cpu() - cT).abs().max()) <= 1e-3
    cam = multiseq_throughput.default_camera(W, H)
    renderers, trajs = multiseq_throughput.sequence_scenes(S, 2, cam)
    imgs = np.stack([r.render(t[1]) for r, t in zip(renderers, trajs)])
    feats = ORBExtractor(ORBConfig(n_features=512, n_levels=4), H, W)(
        torch.from_numpy(imgs.astype(np.float32)))
    pts = torch.cat([(feats.xy - torch.tensor([W / 2, H / 2])) / (0.8 * W) * 4,
                     torch.full(feats.xy.shape[:2] + (1,), 4.0)], -1)
    state = (imgs, feats.desc, feats.valid, pts + torch.tensor([0.02, 0, 0]),
             torch.eye(4).expand(S, 4, 4).contiguous())
    T, n_in, n_match = step(*state)
    cT, c_in, c_match = cpu_step(*state)
    assert int(c_match) > 1000 and int(c_in) > 1000
    assert abs(int(n_match) - int(c_match)) <= 0.01 * int(c_match)
    assert abs(int(n_in) - int(c_in)) <= 0.01 * int(c_in)
    assert float((T.cpu() - cT).abs().max()) <= 1e-3
    R = T[:, :3, :3].cpu()
    assert float((R @ R.transpose(1, 2) - torch.eye(3)).abs().max()) <= 1e-3


def test_sharded_solvers_on_an_nccl_rank(dev, tmp_path):
    """The sharded global BA and essential graph on a one-rank NCCL group
    on the card: bit-equal to the unsharded solves on the card, which
    test_bundle_adjust_cg_matches_cpu and the essential-graph test hold
    against the CPU; the mesh step on a tracked state with totals equal to
    the CPU's unsharded step and poses within 1e-4 of it; then
    multiseq.dryrun(1) on that group."""
    import os

    import torch.distributed as dist
    from orb_slam_system_tpu_torch.parallel import multiseq
    from orb_slam_system_tpu_torch.parallel.ba_dist import (
        bundle_adjust_cg_sharded)
    from orb_slam_system_tpu_torch.parallel.pose_graph_dist import (
        optimize_essential_graph_sharded)
    from orb_slam_system_tpu_torch.solvers.local_ba import (BAProblem,
                                                           bundle_adjust_cg)
    from orb_slam_system_tpu_torch.solvers.pose_graph import (
        optimize_essential_graph)
    rng = np.random.default_rng(0)
    C, P = 5, 101
    X = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    X[:, 2] += 6.0
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    Tcw[:, 0, 3] = -0.2 * np.arange(C)
    Xc = np.einsum("cij,pj->cpi", Tcw[:, :3, :3], X) + Tcw[:, None, :3, 3]
    uv = (Xc[..., :2] / Xc[..., 2:] * 300.0 + 160.0).reshape(-1, 2)
    E = C * P
    prob = BAProblem(*_to(
        dev, Tcw, np.arange(C) == 0, np.ones(C, bool), X + 0.02,
        np.ones(P, bool), np.repeat(np.arange(C), P), np.tile(np.arange(P), C),
        (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32),
        np.ones(E, np.float32), np.ones(E, bool)))
    K = 9
    t0 = (rng.normal(size=(K, 3)) * 0.1).astype(np.float32)
    eg = _to(dev, np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)), t0,
             np.ones(K, np.float32), np.arange(K) == 0, np.ones(K, bool),
             np.arange(K - 1), np.arange(1, K),
             np.tile(np.eye(3, dtype=np.float32), (K - 1, 1, 1)),
             np.full((K - 1, 3), 0.1, np.float32), np.ones(K - 1, np.float32),
             np.ones(K - 1, bool))
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        for got, want in (
                (bundle_adjust_cg_sharded(prob, 300.0, 300.0, 160.0, 160.0,
                                          n_iters=4, cg_iters=30),
                 bundle_adjust_cg(prob, 300.0, 300.0, 160.0, 160.0, n_iters=4,
                                  cg_iters=30)),
                (optimize_essential_graph_sharded(*eg, n_iters=5, cg_iters=20),
                 optimize_essential_graph(*eg, n_iters=5, cg_iters=20))):
            for a, b in zip(got, want):
                assert a.is_cuda and torch.equal(a, b)
        # The mesh step at one rank on a tracked state, against the
        # unsharded step on the CPU on the same state.
        step, args = multiseq.make_multiseq_step(
            96, 128, n_features=128, n_levels=2, device=dev,
            mesh=multiseq.make_mesh(1))
        state = multiseq.tracked_args(args[0], 128, 2)
        T, n_in, n_match = step(*state)
        step_c, _ = multiseq.make_multiseq_step(
            96, 128, n_features=128, n_levels=2, n_sequences=2, device="cpu")
        T_c, n_in_c, n_match_c = step_c(*(a.cpu() for a in state))
        assert 150 <= int(n_match_c) <= 256
        assert (int(n_in), int(n_match)) == (int(n_in_c), int(n_match_c))
        torch.testing.assert_close(T.cpu(), T_c, rtol=1e-4, atol=1e-4)
        n_in, n_match = multiseq.dryrun(1)
        assert 150 <= n_match <= 256 and n_in >= 0.8 * n_match
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_nccl(dev):
    """dryrun_multichip over every card, one NCCL rank each."""
    from orb_slam_system_tpu_torch.parallel import multiseq
    multiseq.dryrun_multichip(torch.cuda.device_count(), "nccl")


def test_warm_pass_on_the_card(dev):
    """warm() at 320x240 on the card runs both modes, and the kernel
    library is among the libraries built."""
    from orb_slam_system_tpu_torch.drivers.mono_synthetic import make_config
    from orb_slam_system_tpu_torch.utils import warmup
    seconds = warmup.warm(make_config(n_features=400), n_frames=6,
                          verbose=True, device="cuda")
    assert set(seconds) == {m for m, _, _ in warmup.MODES}
    assert any(p.name == "liborb_kernels.so" for p in warmup.built_libraries())


# ---- kernel E: the pose LM (csrc/pose_lm.cu) against the eager `_lm` ----

PFX = PFY = 500.0
PCX, PCY = 320.0, 240.0
PBF = 40.0


def _pose_problem(rng, N=160, stereo=False, n_out=20):
    """tests/test_torch_pose_opt.py's _problem at N edges: points 4-10 m
    ahead, 0.5 px noise, n_out outliers 20-80 px off, half the edges stereo
    when asked, 5% invalid, a start 0.03 off the true pose."""
    from orb_slam_system_tpu_torch.utils.lie import se3_exp
    X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                  rng.uniform(4, 10, N)], axis=1).astype(np.float32)
    T_true = se3_exp(torch.from_numpy(
        (rng.normal(size=6) * [0.2, 0.2, 0.2, 0.05, 0.05, 0.05]).astype(np.float32))).numpy()
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([PFX * Xc[:, 0] / Xc[:, 2] + PCX,
                   PFY * Xc[:, 1] / Xc[:, 2] + PCY], axis=1)
    uv = (uv + rng.normal(size=uv.shape) * 0.5).astype(np.float32)
    out = rng.choice(N, size=n_out, replace=False)
    uv[out] += rng.uniform(20, 80, size=(n_out, 2)).astype(np.float32)
    ur = np.full(N, -1.0, np.float32)
    if stereo:
        st = rng.uniform(size=N) < 0.5
        ur[st] = (uv[st, 0] - PBF / Xc[st, 2]
                  + rng.normal(size=st.sum()) * 0.5).astype(np.float32)
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, N))).astype(np.float32)
    valid = rng.uniform(size=N) < 0.95
    dxi = (rng.normal(size=6) * 0.03).astype(np.float32)
    T0 = (se3_exp(torch.from_numpy(dxi)).numpy() @ T_true).astype(np.float32)
    return [T0, X, uv, inv_s2, valid, ur]


def _pose_case(case):
    """(numpy T0, Xw, obs, inv_sigma2, valid, obs_ur or None) of a case."""
    rng = np.random.default_rng(7)
    if case == "batch5":
        probs = [_pose_problem(rng, 1024, n_out=100) for _ in range(5)]
        p = [np.stack(a) for a in zip(*probs)]
        p[5] = None
        return p
    N = {"mono": 160, "stereo": 160, "n1024_invalid_tail": 1024,
         "n2048": 2048, "n333": 333, "n10000": 10000, "all_invalid": 300,
         "behind_camera": 300}[case]
    p = _pose_problem(rng, N, stereo=case in ("stereo", "n1024_invalid_tail"),
                      n_out=N // 10)
    if case == "n1024_invalid_tail":
        p[4][1000:] = False
        p[1][1000:] = 0.0
    elif case == "all_invalid":
        p[4][:] = False
    elif case == "behind_camera":
        p[1][:60, 2] *= -1.0
    return p


def _pose_args(dev, p):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in p]


def _pose_lm_call(dev, p):
    from orb_slam_system_tpu_torch.solvers import pose_opt
    T0, X, uv, inv_s2, valid, ur = _pose_args(dev, p)
    if T0.dim() == 3:
        return pose_opt.pose_optimization_batch(T0, X, uv, inv_s2, valid,
                                                PFX, PFY, PCX, PCY)
    return pose_opt.pose_optimization(T0, X, uv, inv_s2, valid, PFX, PFY,
                                      PCX, PCY, obs_ur=ur, bf=PBF)


@pytest.mark.parametrize("case", ["mono", "stereo", "batch5",
                                  "n1024_invalid_tail", "n2048", "n333",
                                  "n10000", "all_invalid", "behind_camera"])
def test_pose_lm_kernel_matches_eager_lm(dev, case):
    """pose_optimization(_batch) on the card takes kernel E once a call and
    agrees with the eager `_lm` on the card: pose atol 1e-4 (the tolerance
    of tests/test_torch_pose_opt.py), equal inlier masks and counts. With
    every edge invalid the pose is returned unchanged and no edge counts.
    N = 10,000 edges, ten times tracking's, shows that no N is refused."""
    from orb_slam_system_tpu_torch.solvers import pose_opt
    from orb_slam_system_tpu_torch.utils import kernels
    p = _pose_case(case)
    before = kernels.LAUNCHES["pose_lm"]
    T, inl, n = _pose_lm_call(dev, p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pose_lm"] == before + 1
    T0, X, uv, inv_s2, valid, ur = _pose_args(dev, p)
    bf = PBF if ur is not None else 0.0
    Te, inle, ne = pose_opt._lm(T0, X, uv, inv_s2, valid, PFX, PFY, PCX, PCY,
                                ur, bf, 4, 10, None)
    assert T.device == T0.device and T.dtype == torch.float32
    assert T.shape == T0.shape
    assert inl.dtype == torch.bool and n.dtype == torch.int64
    np.testing.assert_allclose(T.cpu().numpy(), Te.cpu().numpy(), rtol=0,
                               atol=1e-4)
    assert torch.equal(inl, inle) and torch.equal(n, ne)
    if case == "all_invalid":
        assert torch.equal(T, T0) and int(n) == 0
    else:
        assert (n > 0).all()


@pytest.mark.parametrize("case", ["mono", "stereo", "batch5"])
def test_pose_lm_kernel_matches_jax(dev, case):
    """Kernel E on the card against the JAX package's answer to the same
    inputs (tests/golden/pose_lm_jax.npz, written and kept current on the
    CPU by tests/test_torch_pose_opt.py): pose atol 1e-4, equal inlier
    masks and counts."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        "pose_lm_jax.npz")
    with np.load(path) as f:
        ref = {k.split(".", 1)[1]: f[k] for k in f.files
               if k.startswith(case + ".")}
    p = [ref[k] for k in ("T0", "Xw", "obs", "inv_sigma2", "valid")]
    T, inl, n = _pose_lm_call(dev, p + [ref.get("obs_ur")])
    np.testing.assert_allclose(T.cpu().numpy(), ref["T"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl.cpu().numpy(), ref["inlier"])
    np.testing.assert_array_equal(n.cpu().numpy(), ref["n_inliers"])


def test_pose_lm_kernel_no_sync_and_bit_equal_runs(dev):
    """Kernel E reads nothing back to the host (CUDA's sync debug mode
    "error" around the calls), and two runs are bit-equal (fixed-order
    reductions, no atomics)."""
    p = _pose_case("n1024_invalid_tail")
    _pose_lm_call(dev, p)
    args = [_pose_args(dev, p) for _ in range(2)]
    torch.cuda.synchronize()
    from orb_slam_system_tpu_torch.solvers import pose_opt
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for T0, X, uv, inv_s2, valid, ur in args:
            outs.append(pose_opt.pose_optimization(
                T0, X, uv, inv_s2, valid, PFX, PFY, PCX, PCY, obs_ur=ur,
                bf=PBF))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_pose_lm_wrapper_checks_arguments(dev):
    """The wrapper raises TypeError on a wrong dtype and ValueError on a
    non-contiguous or misshapen input on the card."""
    from orb_slam_system_tpu_torch.solvers import pose_opt
    T0, X, uv, inv_s2, valid, ur = _pose_args(dev, _pose_case("mono"))
    ok = dict(Tcw0=T0, Xw=X, obs=uv, obs_ur=ur, inv_sigma2=inv_s2,
              valid=valid, fx=PFX, fy=PFY, cx=PCX, cy=PCY, bf=PBF)
    with pytest.raises(TypeError):
        pose_opt.pose_lm(**{**ok, "Xw": X.double()})
    with pytest.raises(TypeError):
        pose_opt.pose_lm(**{**ok, "valid": valid.to(torch.uint8)})
    with pytest.raises(ValueError):
        pose_opt.pose_lm(**{**ok, "obs": uv.repeat(1, 2)[:, ::2]})
    with pytest.raises(ValueError):
        pose_opt.pose_lm(**{**ok, "inv_sigma2": inv_s2[:-1]})
