"""Port ORBExtractor against the JAX ORBExtractor on the CPU (XLA path),
same rendered frames.

Criteria: identical valid keypoint sets, or >= 99% with every difference on
a pyramid level whose image differs between the two (the cascaded resize
may round differently by an ulp, which can flip a FAST near-tie; such
differences are counted, not hidden). Descriptor bits equal except where the
angle bin differs (counted separately).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.config import ORBConfig as JORBConfig
from orb_slam_system_tpu.dataio.synthetic import (PlanarSceneRenderer,
                                                  make_texture, orbit_trajectory)
from orb_slam_system_tpu.ops import pyramid as jpyramid
from orb_slam_system_tpu.ops.brief import _angle_bins as j_bins
from orb_slam_system_tpu.ops.extractor import ORBExtractor as JExtractor
from orb_slam_system_tpu_torch.config import ORBConfig
from orb_slam_system_tpu_torch.ops import pyramid
from orb_slam_system_tpu_torch.ops.brief import _angle_bins
from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(h, w, n=2):
    K = np.array([[520.0 * w / 640, 0, w / 2], [0, 520.0 * w / 640, h / 2],
                  [0, 0, 1]])
    r = PlanarSceneRenderer(K, w, h, texture=make_texture(1024, 8, 7),
                            tex_scale=440.0 * w / 640)
    return [np.clip(r.render(T), 0, 255).astype(np.uint8).astype(np.float32)
            for T in orbit_trajectory(n, radius=0.35, depth=-2.0, tilt=0.3)]


@pytest.mark.parametrize("h,w,n_levels,n_features",
                         [(120, 160, 4, 256), (240, 320, 8, 500)])
def test_extractor_matches_jax(h, w, n_levels, n_features):
    jx = JExtractor(JORBConfig(n_features=n_features, n_levels=n_levels), h, w)
    px = ORBExtractor(ORBConfig(n_features=n_features, n_levels=n_levels), h, w)
    assert px.n_slots == jx.n_slots and px.budgets == jx.budgets
    for img in _frames(h, w):
        img = img[None]
        fj = jax.tree.map(np.asarray, jx(jnp.asarray(img)))
        fp = px(torch.from_numpy(img))
        vj, vp = fj.valid[0], fp.valid[0].numpy()
        kj = {(x, y, o) for (x, y), o in zip(fj.xy[0][vj], fj.octave[0][vj])}
        kp = {(x, y, o) for (x, y), o in zip(fp.xy[0].numpy()[vp],
                                            fp.octave[0].numpy()[vp])}
        diff = kj ^ kp
        if diff:
            lv_j = jpyramid.build_pyramid(jnp.asarray(img), n_levels, 1.2)
            lv_p = pyramid.build_pyramid(torch.from_numpy(img), n_levels, 1.2)
            differing = {l for l in range(n_levels)
                         if not np.array_equal(np.asarray(lv_j[l]), lv_p[l].numpy())}
            assert len(kj & kp) >= 0.99 * len(kj)
            assert {o for _, _, o in diff} <= differing, (diff, differing)
            continue
        # Identical sets: slot-for-slot comparison of everything else.
        np.testing.assert_array_equal(fp.xy[0].numpy(), fj.xy[0])
        np.testing.assert_array_equal(vp, vj)
        np.testing.assert_array_equal(fp.octave[0].numpy(), fj.octave[0])
        np.testing.assert_allclose(fp.response[0].numpy(), fj.response[0],
                                   rtol=0, atol=1e-3)
        bins_j = np.asarray(j_bins(jnp.asarray(fj.angle)))[0]
        bins_p = _angle_bins(fp.angle).numpy()[0]
        flips = (bins_j != bins_p) & vj
        assert flips.sum() <= 0.01 * vj.sum(), f"{flips.sum()} angle-bin flips"
        desc_diff = (fp.desc[0].numpy().view(np.uint32) != fj.desc[0]).any(1)
        assert not (desc_diff & vj & ~flips).any(), \
            f"{(desc_diff & vj & ~flips).sum()} descriptors differ off flips"
