"""The port's stereo and RGB-D front end against the JAX package on the CPU:
stereo_match, rgbd_pseudo_stereo, the batch-2 extraction of a stereo pair,
the 18-column packed frame and local BA with stereo edges.

Inputs: a rendered 320x240 rectified pair (drivers/stereo_synthetic, frame 0
of its orbit) at 400 features, and seeded numpy.

Tolerances: matched masks equal; u_right within 1e-3 px and depth within
1e-4 m where both packages matched (the SAD sums are float32 sums taken in
another order, and XLA's CPU dot can round one resize tap an ulp away from
the port's); the batch-2 extraction bit-equal to two batch-1 extractions;
local BA poses within 1e-4, points 1e-3 relative, inlier masks equal.

One difference is by design: the JAX package's median-SAD filter takes
jnp.median over an array whose unmatched slots are NaN, which is NaN as
soon as one slot is unmatched, so there the filter never drops a match. The
port takes the median over the matched keypoints (the mean of the two
middle values for an even count, jnp.nanmedian's rule) and drops matches
above 1.5 * 1.4 times it. So the port's matches are the JAX package's minus
exactly those the filter drops; they are counted and each is checked
against the rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.config import (CameraConfig as JCameraConfig,
                                        ORBConfig as JORBConfig, Sensor as JSensor,
                                        SlamConfig as JSlamConfig)
from orb_slam_system_tpu.models.frame import FrameBuilder as JFrameBuilder
from orb_slam_system_tpu.ops import stereo as jstereo
from orb_slam_system_tpu.ops.extractor import ORBExtractor as JExtractor
from orb_slam_system_tpu.solvers import local_ba as jlba
from orb_slam_system_tpu_torch.drivers.stereo_synthetic import (make_config,
                                                                render_pairs)
from orb_slam_system_tpu_torch.models.frame import FrameBuilder
from orb_slam_system_tpu_torch.ops import pyramid, stereo
from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
from orb_slam_system_tpu_torch.solvers import local_ba
from orb_slam_system_tpu_torch.utils.interop import (ba_problem_from_numpy,
                                                     feature_set_from_numpy,
                                                     packed_frame_from_numpy)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_FEATURES = 400


@pytest.fixture(scope="module")
def pair():
    cfg = make_config(320, 240, N_FEATURES)
    pairs, _ = render_pairs(cfg, 1)
    left, right = pairs[0]
    return cfg, left, right


@pytest.fixture(scope="module")
def jax_features(pair):
    """The JAX extractor on [left, right] at batch 2 (numpy FeatureSet)."""
    cfg, left, right = pair
    jx = JExtractor(JORBConfig(n_features=N_FEATURES), 240, 320)
    return jax.tree.map(np.asarray, jx(jnp.asarray(np.stack([left, right]))))


def _sides(fs):
    """stereo_match's per-side keypoint arguments of a batch-2 FeatureSet."""
    return [a for b in (0, 1) for a in (fs.xy[b], fs.octave[b], fs.desc[b],
                                        fs.valid[b])]


def test_stereo_match_matches_jax(pair, jax_features):
    """The same keypoints (the JAX extractor's) into both stereo_match
    functions, the port's on its own pyramid of the same pair."""
    cfg, left, right = pair
    c = cfg.camera
    fs = jax_features
    scales = np.asarray(cfg.orb.level_scales(), np.float32)
    ju, jd = (np.asarray(a) for a in jstereo.stereo_match(
        jnp.asarray(left), jnp.asarray(right),
        *(jnp.asarray(a) for a in _sides(fs)), jnp.asarray(scales), c.bf,
        0.0, c.fx))
    pf = feature_set_from_numpy(fs, "cpu")
    levels = pyramid.build_pyramid(torch.from_numpy(np.stack([left, right])),
                                   cfg.orb.n_levels, cfg.orb.scale_factor)
    args = ([l[0] for l in levels], [l[1] for l in levels], *_sides(pf),
            torch.from_numpy(scales))
    pu, pd = (a.numpy() for a in stereo.stereo_match(*args, c.bf, 0.0, c.fx))
    pre, _, _, sad = (a.numpy() for a in stereo.stereo_refine(*args, 0.0, c.fx))
    jm, pm = ju >= 0, pu >= 0
    # Before the median filter the two match the same keypoints.
    np.testing.assert_array_equal(pre, jm)
    assert jm.sum() > 300
    # The filter's median over the matched SADs is jnp.nanmedian's.
    med = float(jnp.nanmedian(jnp.where(jnp.asarray(pre), jnp.asarray(sad),
                                        jnp.nan)))
    assert abs(stereo.masked_median(torch.from_numpy(sad),
                                    torch.from_numpy(pre)).item() - med) < 1e-3
    dropped = jm & ~pm
    np.testing.assert_array_equal(dropped, pre & (sad > 1.5 * 1.4 * med))
    assert not (pm & ~jm).any()
    print(f"stereo_match: {int(jm.sum())} matched in JAX, the port's median "
          f"filter drops {int(dropped.sum())} (SAD > {2.1 * med:.1f})")
    np.testing.assert_allclose(pu[pm], ju[pm], atol=1e-3)
    np.testing.assert_allclose(pd[pm], jd[pm], atol=1e-4)
    assert (pd[pm] > 0).all() and (pd[~pm] == -1).all() and (pu[~pm] == -1).all()


def test_stereo_match_all_unmatched(pair, jax_features):
    """No valid right keypoint: every u_right and depth -1 in both packages,
    and the median falls back to NO_MEDIAN (JAX: nan_to_num(..., 1e9))."""
    cfg, left, right = pair
    c = cfg.camera
    fs = jax_features._replace(valid=jax_features.valid.copy())
    fs.valid[1] = False
    scales = np.asarray(cfg.orb.level_scales(), np.float32)
    ju, jd = (np.asarray(a) for a in jstereo.stereo_match(
        jnp.asarray(left), jnp.asarray(right),
        *(jnp.asarray(a) for a in _sides(fs)), jnp.asarray(scales), c.bf,
        0.0, c.fx))
    pf = feature_set_from_numpy(fs, "cpu")
    levels = pyramid.build_pyramid(torch.from_numpy(np.stack([left, right])),
                                   cfg.orb.n_levels, cfg.orb.scale_factor)
    pu, pd = stereo.stereo_match([l[0] for l in levels], [l[1] for l in levels],
                                 *_sides(pf), torch.from_numpy(scales), c.bf,
                                 0.0, c.fx)
    assert (ju == -1).all() and (jd == -1).all()
    assert (pu.numpy() == -1).all() and (pd.numpy() == -1).all()
    empty = torch.zeros(8, dtype=torch.bool)
    assert stereo.masked_median(torch.arange(8.0), empty).item() == stereo.NO_MEDIAN


@pytest.mark.parametrize("n", [1, 2, 7, 8, 400])
def test_masked_median_is_nanmedian(rng, n):
    """Odd and even counts: the mean of the two middle values, as
    jnp.nanmedian (torch.median and torch.nanmedian return the lower one,
    which differs at an even count)."""
    v = rng.uniform(0, 500, size=512).astype(np.float32)
    mask = np.zeros(512, bool)
    mask[rng.choice(512, size=n, replace=False)] = True
    want = float(jnp.nanmedian(jnp.where(mask, v, jnp.nan)))
    got = stereo.masked_median(torch.from_numpy(v), torch.from_numpy(mask)).item()
    assert got == pytest.approx(want, abs=1e-4)
    if n % 2 == 0:
        assert torch.from_numpy(v[mask]).median().item() < want


def test_rgbd_pseudo_stereo_matches_jax(rng):
    """A seeded depth map with holes and keypoints past its edges."""
    H, W, N = 240, 320, 512
    depth = rng.uniform(0, 5000 * 4, size=(H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.2] = 0.0
    xy = rng.uniform(-3, [W + 3, H + 3], size=(N, 2)).astype(np.float32)
    und = (xy + rng.normal(size=(N, 2)) * 0.3).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    ju, jd = (np.asarray(a) for a in jstereo.rgbd_pseudo_stereo(
        jnp.asarray(depth), jnp.asarray(xy), jnp.asarray(und),
        jnp.asarray(valid), 40.0, jnp.asarray(1.0 / 5000, jnp.float32)))
    pu, pd = (a.numpy() for a in stereo.rgbd_pseudo_stereo(
        torch.from_numpy(depth), torch.from_numpy(xy), torch.from_numpy(und),
        torch.from_numpy(valid), 40.0, 1.0 / 5000))
    np.testing.assert_array_equal(pu >= 0, ju >= 0)
    np.testing.assert_array_equal(pd > 0, jd > 0)
    np.testing.assert_allclose(pu, ju, atol=1e-3)
    np.testing.assert_allclose(pd, jd, atol=1e-4)


def test_stereo_frame_matches_jax(pair):
    """The whole stereo frame build, port against JAX: the packed f32[N, 18]
    frames agree column by column (octaves, validity and descriptors equal;
    xy, undistorted xy, response and angle within 1e-4, where XLA's CPU
    arithmetic rounds an upper level's scale-up or the undistortion an ulp
    differently; u_right and depth as in the stereo match), and
    the 18 columns cross into the port and back through FrameFeatures."""
    cfg, left, right = pair
    c = cfg.camera
    jcfg = JSlamConfig(camera=JCameraConfig(
        fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, fps=30.0, width=c.width,
        height=c.height, bf=c.bf), orb=JORBConfig(n_features=N_FEATURES),
        sensor=JSensor.STEREO, th_depth=35.0)
    jp = np.asarray(JFrameBuilder(jcfg)._extract_packed_stereo(
        jnp.asarray(left), jnp.asarray(right)))
    fb = FrameBuilder(cfg, "cpu")
    pp = fb.extract_packed_stereo(left, right).numpy()
    assert pp.shape == jp.shape == (fb.extractor.n_slots, 18)
    np.testing.assert_array_equal(pp[:, 6:8], jp[:, 6:8])
    np.testing.assert_allclose(pp[:, :6], jp[:, :6], rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(pp[:, 8:16].view(np.uint32),
                                  jp[:, 8:16].view(np.uint32))
    pm, jm = pp[:, 16] >= 0, jp[:, 16] >= 0
    assert not (pm & ~jm).any() and pm.sum() > 300
    np.testing.assert_allclose(pp[pm, 16], jp[pm, 16], atol=1e-3)
    np.testing.assert_allclose(pp[pm, 17], jp[pm, 17], atol=1e-4)
    # The JAX frame carried into the port (its bits, 18 columns) unpacks as
    # the port's own FrameFeatures with u_right and depth.
    carried = packed_frame_from_numpy(jp, "cpu")
    assert torch.equal(carried.view(torch.int32),
                       torch.from_numpy(jp.view(np.int32)))
    feats = FrameBuilder._unpack_feats(carried.numpy())
    np.testing.assert_array_equal(feats.u_right, jp[:, 16])
    np.testing.assert_array_equal(feats.depth, jp[:, 17])
    assert FrameBuilder._unpack_feats(pp[:, :16]).u_right is None


def test_batch2_extraction_equals_batch1(pair):
    """[left, right] at batch 2 gives, image by image, bit for bit the
    batch-1 extraction, and the pyramid levels it returns are the ones a
    batch-1 extraction builds."""
    cfg, left, right = pair
    ex = ORBExtractor(cfg.orb, 240, 320)
    both, lv2 = ex.extract(torch.from_numpy(np.stack([left, right])))
    for b, img in enumerate((left, right)):
        one, lv1 = ex.extract(torch.from_numpy(img)[None])
        for f2, f1 in zip(both, one):
            assert torch.equal(f2[b], f1[0])
        for l2, l1 in zip(lv2, lv1):
            assert torch.equal(l2[b], l1[0])


def _stereo_ba_problem(rng, C=4, P=80, bf=31.2):
    """A seeded local window: C cameras (the first fixed), P points seen by
    three cameras each, 0.5 px noise; half the edges stereo (u_right =
    u - bf / z, plus noise), the rest monocular (-1)."""
    fx = fy = 260.0
    cx, cy = 160.0, 120.0
    X = np.stack([rng.uniform(-1, 1, P), rng.uniform(-0.8, 0.8, P),
                  rng.uniform(2, 4, P)], 1).astype(np.float32)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    Tcw[:, 0, 3] = -0.1 * np.arange(C)
    Tcw[:, 1, 3] = 0.03 * np.arange(C)
    e_cam, e_pt = [], []
    for p in range(P):
        for c in rng.choice(C, size=3, replace=False):
            e_cam.append(c)
            e_pt.append(p)
    e_cam, e_pt = np.asarray(e_cam, np.int32), np.asarray(e_pt, np.int32)
    Xc = np.einsum("eij,ej->ei", Tcw[e_cam, :3, :3], X[e_pt]) + Tcw[e_cam, :3, 3]
    u = fx * Xc[:, 0] / Xc[:, 2] + cx
    v = fy * Xc[:, 1] / Xc[:, 2] + cy
    E = len(e_cam)
    uv = (np.stack([u, v], 1) + rng.normal(size=(E, 2)) * 0.5).astype(np.float32)
    ur = (u - bf / Xc[:, 2] + rng.normal(size=E) * 0.5).astype(np.float32)
    ur[rng.permutation(E)[:E // 2]] = -1.0
    Tcw0 = Tcw.copy()
    Tcw0[1:, :3, 3] += rng.normal(size=(C - 1, 3)).astype(np.float32) * 0.01
    X0 = (X + rng.normal(size=X.shape) * 0.02).astype(np.float32)
    prob = jlba.BAProblem(
        Tcw=jnp.asarray(Tcw0), cam_fixed=jnp.asarray(np.arange(C) == 0),
        cam_valid=jnp.ones(C, bool), points=jnp.asarray(X0),
        pt_valid=jnp.ones(P, bool), e_cam=jnp.asarray(e_cam),
        e_pt=jnp.asarray(e_pt), e_uv=jnp.asarray(uv),
        e_inv_sigma2=jnp.ones(E, jnp.float32), e_valid=jnp.ones(E, bool),
        e_ur=jnp.asarray(ur), bf=bf)
    return prob, (fx, fy, cx, cy), (ur >= 0).mean()


def test_local_ba_with_stereo_edges_matches_jax(rng):
    prob, cam, stereo_share = _stereo_ba_problem(rng)
    assert 0.45 < stereo_share < 0.55
    C, P, E = (np.asarray(prob.Tcw).shape[0], np.asarray(prob.points).shape[0],
               np.asarray(prob.e_cam).shape[0])
    want = np.asarray(jlba.local_bundle_adjustment_packed(prob, *cam))
    got = local_ba.local_bundle_adjustment_packed(
        ba_problem_from_numpy(prob, "cpu"), *cam).numpy()
    gT, gX, ginl = local_ba.unpack_local_ba(got, C, P, E)
    wT, wX, winl = jlba.unpack_local_ba(want, C, P, E)
    np.testing.assert_allclose(gT, wT, atol=1e-4)
    np.testing.assert_allclose(gX, wX, atol=1e-3 * np.abs(wX).max())
    np.testing.assert_array_equal(ginl, winl)
    # The stereo edges pulled the solution: without them it differs.
    mono = ba_problem_from_numpy(prob._replace(e_ur=None), "cpu")
    gT_mono = local_ba.unpack_local_ba(local_ba.local_bundle_adjustment_packed(
        mono, *cam).numpy(), C, P, E)[0]
    assert np.abs(gT_mono - gT).max() > 1e-4
