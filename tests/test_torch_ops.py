"""Port ops against the JAX package on the CPU, on the same numpy inputs.

Each kernel wrapper is called with CPU tensors, so it runs its plain
PyTorch version; the JAX side runs its XLA formulation (the oracle its own
CPU tests use). Tolerances are stated per test.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.dataio.synthetic import (PlanarSceneRenderer,
                                                  make_texture, orbit_trajectory)
from orb_slam_system_tpu.ops import brief as jbrief
from orb_slam_system_tpu.ops import fast as jfast
from orb_slam_system_tpu.ops import frustum as jfrustum
from orb_slam_system_tpu.ops import hamming as jhamming
from orb_slam_system_tpu.ops import matching as jmatching
from orb_slam_system_tpu.ops import pyramid as jpyramid
from orb_slam_system_tpu.ops.extractor import _blur_patches as j_blur
from orb_slam_system_tpu.ops.orientation import HALF_PATCH
from orb_slam_system_tpu.ops.orientation import moment_weights as j_weights
from orb_slam_system_tpu.ops.patches import gather_patches as j_gather
from orb_slam_system_tpu_torch.ops import brief, fast, frustum, hamming, matching
from orb_slam_system_tpu_torch.ops import pyramid
from orb_slam_system_tpu_torch.ops.patches import (gather_blur_moments,
                                                   gather_patches_plain)


def _rendered(h, w, i=0):
    K = np.array([[520.0 * w / 640, 0, w / 2], [0, 520.0 * w / 640, h / 2],
                  [0, 0, 1]])
    r = PlanarSceneRenderer(K, w, h, texture=make_texture(1024, 8, 7),
                            tex_scale=440.0 * w / 640)
    T = orbit_trajectory(3, radius=0.35, depth=-2.0, tilt=0.3)[i]
    return np.clip(r.render(T), 0, 255).astype(np.uint8).astype(np.float32)


def _random_u32(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def _t32(a):
    """uint32 numpy -> int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.mark.parametrize("source", ["random", "rendered", "rendered_level3"])
def test_fast_score_nms_exact(source, rng):
    """Kernel A's plain version: exact (only subtract/min/max)."""
    if source == "random":
        img = rng.integers(0, 256, size=(2, 120, 160)).astype(np.float32)
    else:
        img = _rendered(120, 160)[None]
        if source == "rendered_level3":   # non-integer pixel values
            img = np.array(jpyramid.build_pyramid(jnp.asarray(img), 4, 1.2)[3])
    want = np.asarray(jfast.nms3x3(jfast.fast_score_map(jnp.asarray(img), 19)))
    got = fast.fast_score_nms(torch.from_numpy(img), 19).numpy()
    np.testing.assert_array_equal(got, want)


def test_pyramid_matches_jax():
    """Two-tap resize vs the JAX matmul resize: equal up to f32 rounding
    (XLA's CPU dot may contract a tap into an FMA; 1e-4 is < 1 ulp at 255
    times 8 levels of cascade)."""
    img = _rendered(240, 320)[None]
    want = jpyramid.build_pyramid(jnp.asarray(img), 8, 1.2)
    got = pyramid.build_pyramid(torch.from_numpy(img), 8, 1.2)
    for w, g in zip(want, got):
        assert tuple(w.shape) == tuple(g.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    # The taps are exactly the JAX package's resize matrix.
    M = jpyramid._resize_matrix(200, 240)
    i0, i1, w0, w1 = pyramid._resize_taps(200, 240)
    R = np.zeros_like(M)
    np.add.at(R, (np.arange(200), i0), w0)
    np.add.at(R, (np.arange(200), i1), w1)
    np.testing.assert_array_equal(R, M)


def test_gather_blur_moments_matches_jax(rng):
    """Kernel B's plain version vs gather_patches + _blur_patches + the
    moment weights: blur rtol 2e-6 / atol 1e-3, moments atol 0.5 (the
    tolerances of tests/test_gather_pallas.py)."""
    B, H, W, N = 2, 96, 160, 32
    img = rng.uniform(0, 255, size=(B, H, W)).astype(np.float32)
    xy = np.stack([rng.integers(0, W, size=(B, N)),
                   rng.integers(0, H, size=(B, N))], axis=-1).astype(np.int32)
    patches = j_gather(jnp.asarray(img), jnp.asarray(xy), 21)
    want_blur = np.asarray(j_blur(patches))
    c0 = 21 - HALF_PATCH
    PO = 2 * HALF_PATCH + 1
    sub = np.asarray(patches)[:, :, c0:c0 + PO, c0:c0 + PO]
    wx, wy = j_weights()
    want_mom = np.stack([(sub * wx).sum(axis=(2, 3)),
                         (sub * wy).sum(axis=(2, 3))], axis=-1)
    blur, mom = gather_blur_moments(torch.from_numpy(img), torch.from_numpy(xy))
    np.testing.assert_allclose(blur.numpy(), want_blur, rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(mom.numpy(), want_mom, rtol=0, atol=0.5)


@pytest.mark.parametrize("values", ["integer", "float"])
def test_brief_pack_matches_dense_oracle(values, rng):
    """Kernel C's plain version vs compute_descriptors_dense on the same
    blurred patches and angles: bit-exact. Angles include exact bin
    centres and edges."""
    N = 96
    if values == "integer":
        patches = rng.integers(0, 256, size=(1, N, 37, 37)).astype(np.float32)
    else:
        patches = rng.uniform(0, 255, size=(1, N, 37, 37)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=(1, N)).astype(np.float32)
    ang[0, :32] = (np.arange(32) * 2 * np.pi / 32).astype(np.float32)
    ang[0, 32:64] = ((np.arange(32) + 0.5) * 2 * np.pi / 32).astype(np.float32)
    want = np.asarray(jbrief.compute_descriptors_dense(jnp.asarray(patches),
                                                       jnp.asarray(ang)))
    got = brief.brief_pack(torch.from_numpy(patches), torch.from_numpy(ang))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        brief._angle_bins(torch.from_numpy(ang)).numpy(),
        np.asarray(jbrief._angle_bins(jnp.asarray(ang))))


def test_offset_table_is_the_test_matrices():
    """The int8 offset table encodes exactly the JAX +-1 test matrices."""
    tab = brief.offset_table().astype(np.int64)
    P = 37
    E = np.zeros((32, P * P, 256), np.float32)
    a, b = np.meshgrid(np.arange(32), np.arange(256), indexing="ij")
    np.add.at(E, (a, tab[..., 1] * P + tab[..., 0], b), -1.0)
    np.add.at(E, (a, tab[..., 3] * P + tab[..., 2], b), 1.0)
    np.testing.assert_array_equal(E, jbrief._binned_test_matrices())


def test_pack_unpack_roundtrip(rng):
    bits = rng.integers(0, 2, size=(5, 256)).astype(np.uint32)
    want = np.asarray(jbrief.pack_bits(jnp.asarray(bits)))
    got = brief.pack_bits(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(brief.unpack_bits(got).numpy(), bits)


def test_hamming_exact(rng):
    a = _random_u32(rng, (40, 8))
    b = _random_u32(rng, (56, 8))
    b[:8] = a[:8]
    want = np.asarray(jhamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = hamming.distance_matrix(_t32(a), _t32(b)).numpy()
    np.testing.assert_array_equal(got, want)
    want_p = np.asarray(jhamming.distance_pairwise(jnp.asarray(a),
                                                   jnp.asarray(b[:40])))
    got_p = hamming.distance_pairwise(_t32(a), _t32(b[:40])).numpy()
    np.testing.assert_array_equal(got_p, want_p)


def _map_points(rng, P=300):
    pos = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1.2, 1.2, P),
                    rng.uniform(1.0, 5.0, P)], axis=1).astype(np.float32)
    n = pos + rng.normal(0, 0.3, size=pos.shape)
    normal = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    maxd = (np.linalg.norm(pos, axis=1) * rng.uniform(0.9, 3.0, P)).astype(np.float32)
    mind = (maxd / 1.2 ** 7).astype(np.float32)
    valid = rng.uniform(size=P) < 0.9
    return pos, normal, mind, maxd, valid


def _pose(rng):
    from orb_slam_system_tpu_torch.utils.lie import se3_exp
    xi = torch.from_numpy(rng.normal(0, 0.05, 6).astype(np.float32))
    return se3_exp(xi).numpy()


def test_frustum_check_matches_jax(rng):
    """visible and pred_level exact; projections to f32 rounding."""
    pos, normal, mind, maxd, valid = _map_points(rng)
    T = _pose(rng)
    args = (500.0, 500.0, 320.0, 240.0, 0.0, 640.0, 0.0, 480.0,
            float(np.log(1.2)), 8)
    want = jfrustum.frustum_check(*map(jnp.asarray, (pos, normal, mind, maxd,
                                                     valid, T)), *args)
    got = frustum.frustum_check(*map(torch.from_numpy, (pos, normal, mind, maxd,
                                                        valid, T)), *args)
    assert got["visible"].sum() > 50
    np.testing.assert_array_equal(got["visible"].numpy(), np.asarray(want["visible"]))
    np.testing.assert_array_equal(got["pred_level"].numpy(),
                                  np.asarray(want["pred_level"]))
    np.testing.assert_allclose(got["proj_xy"].numpy(), np.asarray(want["proj_xy"]),
                               rtol=1e-6, atol=1e-4)


def test_rotation_consistency_exact(rng):
    """Histogram top-3 with ties (lower bin first) and the 0.1x pruning."""
    n = 200
    ang1 = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    rot = rng.choice([0.0, 0.5, 1.0, 3.0], size=n, p=[0.4, 0.25, 0.25, 0.1])
    ang2 = np.mod(ang1 - rot + rng.normal(0, 0.02, n), 2 * np.pi).astype(np.float32)
    matched = rng.uniform(size=n) < 0.8
    want = np.asarray(jmatching.rotation_consistency(
        jnp.asarray(ang1), jnp.asarray(ang2), jnp.asarray(matched)))
    got = matching.rotation_consistency(torch.from_numpy(ang1),
                                        torch.from_numpy(ang2),
                                        torch.from_numpy(matched)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < matched.sum()


def test_search_by_projection_local_map_exact(rng):
    """Window, level band, ratio test, exclusions and column dedupe: exact,
    with many equal distances (descriptors drawn from a small pool)."""
    P, N = 150, 256
    pool = _random_u32(rng, (12, 8))
    desc2 = pool[rng.integers(0, 12, N)]
    xy2 = rng.uniform(0, 120, size=(N, 2)).astype(np.float32)
    oct2 = rng.integers(0, 4, N).astype(np.int32)
    target = rng.integers(0, N, P)           # each point aims at a keypoint
    flips = rng.integers(0, 32, size=(P, 8)).astype(np.uint32)
    desc_mp = desc2[target] ^ np.where(rng.uniform(size=(P, 8)) < 0.5,
                                       np.uint32(1) << flips, np.uint32(0))
    proj = (xy2[target] + rng.normal(0, 2, (P, 2))).astype(np.float32)
    pred = (oct2[target] + rng.integers(0, 2, P)).astype(np.int32)
    radius = (4.0 * 1.2 ** pred).astype(np.float32)
    valid_pt = rng.uniform(size=P) < 0.9
    valid2 = rng.uniform(size=N) < 0.95
    already = rng.uniform(size=N) < 0.1
    want = jmatching.search_by_projection_local_map(
        *map(jnp.asarray, (proj, radius, pred, valid_pt, desc_mp, xy2, desc2,
                           valid2, oct2, already)))
    t = torch.from_numpy
    got = matching.search_by_projection_local_map(
        t(proj), t(radius), t(pred.astype(np.int64)), t(valid_pt), _t32(desc_mp),
        t(xy2), _t32(desc2), t(valid2), t(oct2.astype(np.int64)), t(already))
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(want.idx2))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert (got.idx2 >= 0).sum() > 10


def test_top_n_pads_instead_of_failing():
    """k larger than the candidate count: padded with -inf, not an error
    (the JAX package's lax.top_k raises there)."""
    key = torch.tensor([[3.0, 1.0, 3.0, -float("inf")]])
    vals, idx = fast._top_n(key, 6)
    assert idx.tolist() == [[0, 2, 1, 3, 0, 0]]
    assert torch.isinf(vals[0, 3:]).all()


def test_lie_matches_jax(rng):
    """so3_exp / se3_exp (incl. the small-angle branch), se3_inv and the
    Newton-Schulz se3_project: f32 rounding apart."""
    from orb_slam_system_tpu.utils import lie as jlie
    from orb_slam_system_tpu_torch.utils import lie
    for scale in (1e-6, 0.3, 2.0):
        xi = (rng.normal(size=6) * scale).astype(np.float32)
        T = lie.se3_exp(torch.from_numpy(xi))
        np.testing.assert_allclose(T.numpy(), np.asarray(jlie.se3_exp(jnp.asarray(xi))),
                                   rtol=0, atol=2e-6)
        np.testing.assert_allclose(
            lie.so3_exp(torch.from_numpy(xi[3:])).numpy(),
            np.asarray(jlie.so3_exp(jnp.asarray(xi[3:]))), rtol=0, atol=2e-6)
        np.testing.assert_allclose((lie.se3_inv(T) @ T).numpy(), np.eye(4),
                                   rtol=0, atol=1e-5)
        bad = T.clone()
        bad[:3, :3] *= 1.01
        np.testing.assert_allclose(
            lie.se3_project(bad).numpy(),
            np.asarray(jlie.se3_project(jnp.asarray(bad.numpy()))), rtol=0, atol=2e-6)


def test_camera_matches_jax(rng):
    """undistort_points with real distortion, project, image bounds."""
    from orb_slam_system_tpu.utils import camera as jcam
    from orb_slam_system_tpu_torch.utils import camera
    k = (517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633)
    uv = rng.uniform([0, 0], [640, 480], size=(64, 2)).astype(np.float32)
    np.testing.assert_allclose(
        camera.undistort_points(torch.from_numpy(uv), *k).numpy(),
        np.asarray(jcam.undistort_points(jnp.asarray(uv), *k)), rtol=0, atol=1e-3)
    X = rng.uniform([-1, -1, 1], [1, 1, 5], size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        camera.project(torch.from_numpy(X), *k[:4]).numpy(),
        np.asarray(jcam.project(jnp.asarray(X), *k[:4])), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        camera.compute_image_bounds(640, 480, *k),
        [float(b) for b in jcam.compute_image_bounds(640, 480, *k)], atol=1e-3)


def test_interop_keeps_bits(rng):
    """JAX-side arrays cross into the port's tensors and back with their
    32-bit patterns intact, NaN patterns included."""
    from orb_slam_system_tpu_torch.utils import interop
    desc = _random_u32(rng, (10, 8))
    desc[0, 0] = 0x7FC00001           # a NaN pattern once bit-cast to f32
    xy = rng.uniform(0, 100, (1, 10, 2)).astype(np.float32)
    fs = interop.feature_set_from_numpy(SimpleNamespace(
        xy=xy, response=xy[..., 0], angle=xy[..., 1],
        octave=np.zeros((1, 10), np.int32), desc=desc[None],
        valid=np.ones((1, 10), bool)), "cpu")
    np.testing.assert_array_equal(interop.to_numpy(fs.desc, uint32=True)[0], desc)
    block = interop.local_block_from_numpy(
        xy[0, :, [0, 1, 1]].T, xy[0, :, [1, 0, 0]].T, xy[0, :, 0], xy[0, :, 1],
        desc, np.ones(10, bool), "cpu")
    np.testing.assert_array_equal(interop.to_numpy(block[4], uint32=True), desc)
    packed = np.zeros((10, 16), np.float32)
    packed[:, 8:16] = desc.view(np.float32)
    back = interop.packed_frame_from_numpy(packed, "cpu")
    np.testing.assert_array_equal(back.numpy().view(np.uint32)[:, 8:16], desc)


@pytest.mark.parametrize("radius", [21, 7])
def test_gather_patches_plain_matches_jax(radius, rng):
    """Kernel D's plain version vs the JAX block gather, bit for bit,
    including keypoints whose patch start is clipped at every edge."""
    B, H, W, N = 2, 96, 160, 64
    img = rng.uniform(0, 255, size=(B, H, W)).astype(np.float32)
    xy = np.stack([rng.integers(-10, W + 10, size=(B, N)),
                   rng.integers(-10, H + 10, size=(B, N))],
                  axis=-1).astype(np.int32)
    xy[0, :4] = [[0, 0], [W - 1, H - 1], [-3, H + 2], [W + 5, 1]]
    want = np.asarray(j_gather(jnp.asarray(img), jnp.asarray(xy), radius))
    got = gather_patches_plain(torch.from_numpy(img), torch.from_numpy(xy), radius)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w", [(120, 160), (240, 320)])
def test_unfused_route_matches_jax_extractor(h, w):
    """ORBExtractor(fused_gather=False) (raw gather, IC angle from the 31x31
    centre, plain blur) against the JAX extractor, which takes the same
    route off the TPU: identical keypoints; descriptor bits equal except on
    keypoints whose angle bin differs, counted apart (<= 1%)."""
    from orb_slam_system_tpu.config import ORBConfig as JORBConfig
    from orb_slam_system_tpu.ops.brief import _angle_bins as j_bins
    from orb_slam_system_tpu.ops.extractor import ORBExtractor as JExtractor
    from orb_slam_system_tpu_torch.config import ORBConfig
    from orb_slam_system_tpu_torch.ops.brief import _angle_bins
    from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor

    cfg = dict(n_features=500 if w == 320 else 256, n_levels=8 if w == 320 else 4)
    img = _rendered(h, w, 1)[None]
    jx = JExtractor(JORBConfig(**cfg), h, w)
    assert not jx._fused_gather
    fj = jx(jnp.asarray(img))
    fp = ORBExtractor(ORBConfig(**cfg), h, w, fused_gather=False)(
        torch.from_numpy(img))
    vj = np.asarray(fj.valid[0])
    np.testing.assert_array_equal(fp.valid[0].numpy(), vj)
    np.testing.assert_array_equal(fp.xy[0].numpy(), np.asarray(fj.xy[0]))
    np.testing.assert_array_equal(fp.octave[0].numpy(), np.asarray(fj.octave[0]))
    flips = (_angle_bins(fp.angle).numpy()[0]
             != np.asarray(j_bins(fj.angle))[0]) & vj
    assert flips.sum() <= 0.01 * vj.sum(), f"{flips.sum()} angle-bin flips"
    differ = (fp.desc[0].numpy().view(np.uint32) != np.asarray(fj.desc[0])).any(1)
    assert not (differ & vj & ~flips).any()
