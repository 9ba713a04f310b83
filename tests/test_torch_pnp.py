"""The port's EPnP-RANSAC (solvers/pnp.py) against the JAX package's on the
CPU, on the same numpy inputs and the same sample sets.

Cases: tests/test_pnp.py's three (a clean view, the same with 40 outliers,
random garbage), rebuilt with its generator from the same seed. Criteria:
`ok` equal; inlier masks equal except at most 1% of N; rotation within
0.05 deg and translation within 1e-3 of JAX's final pose (float32 sums in
another order; single hypotheses are not compared, since a rank-deficient
12x12 M^T M has no unique null vector). The garbage case has no pose to
compare and no stable best set (its hypotheses tie at 0-3 inliers, and
ulps pick another), so only `ok` and both inlier counts (< 25) are
compared there. A batch of C = 3 equals
three single calls (within 1e-5, masks exact), and repeated indices in a
sample set weigh once, as JAX's `.at[idx].set(1.0)`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.solvers import pnp as jpnp
from orb_slam_system_tpu.utils import lie as jlie
from orb_slam_system_tpu_torch.solvers import pnp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0


def make_case(rng, N=128, n_out=0, noise=0.3):
    """tests/test_pnp.py's case generator."""
    X = rng.uniform(-3, 3, size=(N, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(4, 10, size=N)
    w = rng.normal(size=3) * 0.3
    R = np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))
    t = rng.normal(size=3).astype(np.float32) * 0.5
    Xc = X @ R.T + t
    Xc[:, 2] = np.abs(Xc[:, 2]) + 3.0
    X = (Xc - t) @ np.linalg.inv(R).T
    uv = (Xc[:, :2] / Xc[:, 2:3]) * [FX, FY] + [CX, CY]
    uv += rng.normal(size=uv.shape) * noise
    if n_out:
        idx = rng.choice(N, size=n_out, replace=False)
        uv[idx] += rng.uniform(40, 120, size=(n_out, 2))
    return X.astype(np.float32), uv.astype(np.float32)


def garbage_case(rng, N=64):
    X = rng.uniform(-3, 3, size=(N, 3)).astype(np.float32)
    X[:, 2] += 6
    uv = rng.uniform(0, 640, size=(N, 2)).astype(np.float32)
    return X, uv


CASES = {
    "clean": lambda: make_case(np.random.default_rng(0)),
    "outliers": lambda: make_case(np.random.default_rng(0), n_out=40),
    "garbage": lambda: garbage_case(np.random.default_rng(0)),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rot_deg(Ra, Rb):
    """Angle of Ra Rb^T in float64 (arccos of a float32 trace cannot
    resolve 0.05 deg)."""
    M = Ra.astype(np.float64) @ Rb.astype(np.float64).T
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.degrees(np.arctan2(0.5 * s, 0.5 * (np.trace(M) - 1.0))))


def _jax(X, uv, valid, sets, inv_s2=None):
    inv_s2 = np.ones(len(uv), np.float32) if inv_s2 is None else inv_s2
    ok, T, inl, n = jpnp.epnp_ransac(
        jnp.asarray(X), jnp.asarray(uv), jnp.asarray(inv_s2),
        jnp.asarray(valid), jnp.asarray(sets), FX, FY, CX, CY)
    return bool(ok), np.asarray(T), np.asarray(inl), int(n)


def _port(X, uv, valid, sets, inv_s2=None):
    inv_s2 = np.ones(len(uv), np.float32) if inv_s2 is None else inv_s2
    ok, T, inl, n = pnp.epnp_ransac(_t(X), _t(uv), _t(inv_s2), _t(valid),
                                    _t(sets.astype(np.int64)), FX, FY, CX, CY)
    return bool(ok), T.numpy(), inl.numpy(), int(n)


def _assert_close(got, want, N, pose=True):
    """pose=False (a garbage candidate): `ok` and the inlier counts only."""
    ok, T, inl, n = got
    jok, jT, jinl, jn = want
    assert ok == jok
    if not pose:
        assert n < 25 and jn < 25
        return
    assert int((inl != jinl).sum()) <= 0.01 * N, (n, jn)
    assert _rot_deg(T[:3, :3], jT[:3, :3]) < 0.05
    np.testing.assert_allclose(T[:3, 3], jT[:3, 3], atol=1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_epnp_ransac_matches_jax(case):
    X, uv = CASES[case]()
    N = len(X)
    valid = np.ones(N, bool)
    sets = pnp.make_pnp_sample_sets(N, 300, seed=0)
    np.testing.assert_array_equal(sets, jpnp.make_pnp_sample_sets(N, 300, 0))
    want = _jax(X, uv, valid, sets)
    got = _port(X, uv, valid, sets)
    _assert_close(got, want, N, pose=case != "garbage")
    if case != "garbage":
        assert got[0] and got[3] > 0.8 * (N - 40)


def test_invalid_slots_and_inverse_sigma():
    """Some slots invalid (remapped through the stable argsort) and
    per-point inverse sigma^2 from octaves, on the outlier case."""
    X, uv = CASES["outliers"]()
    N = len(X)
    rng = np.random.default_rng(3)
    valid = rng.uniform(size=N) < 0.8
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, N))).astype(np.float32)
    sets = pnp.make_pnp_sample_sets(N, 300, seed=0)
    want = _jax(X, uv, valid, sets, inv_s2)
    got = _port(X, uv, valid, sets, inv_s2)
    _assert_close(got, want, N)
    assert not got[2][~valid].any()


def test_batch_equals_single_calls():
    """One epnp_ransac_batch over a good, an outlier-heavy and a garbage
    candidate that share the frame's observations equals three calls."""
    X, uv = CASES["clean"]()
    N = len(X)
    rng = np.random.default_rng(1)
    X_out = X.copy()
    bad = rng.choice(N, size=60, replace=False)
    X_out[bad] = rng.uniform(-3, 3, size=(60, 3)) + [0, 0, 7]
    X_bad = garbage_case(rng, N)[0]
    Xs = np.stack([X, X_out, X_bad]).astype(np.float32)
    valid = np.ones((3, N), bool)
    valid[1, :10] = False
    sets = pnp.make_pnp_sample_sets(N, 300, seed=0)
    inv_s2 = np.ones(N, np.float32)
    ok, T, inl, n = pnp.epnp_ransac_batch(
        _t(Xs), _t(uv), _t(inv_s2), _t(valid), _t(sets.astype(np.int64)),
        FX, FY, CX, CY)
    assert ok.tolist() == [True, True, False]
    jok, jT, jinl, jn = jpnp.epnp_ransac_batch(
        jnp.asarray(Xs), jnp.asarray(uv), jnp.asarray(inv_s2),
        jnp.asarray(valid), jnp.asarray(sets), FX, FY, CX, CY)
    for c in range(3):
        single = _port(Xs[c], uv, valid[c], sets)
        assert bool(ok[c]) == single[0] and int(n[c]) == single[3]
        np.testing.assert_array_equal(inl[c].numpy(), single[2])
        np.testing.assert_allclose(T[c].numpy(), single[1], atol=1e-5)
        _assert_close((bool(ok[c]), T[c].numpy(), inl[c].numpy(), int(n[c])),
                      (bool(jok[c]), np.asarray(jT[c]), np.asarray(jinl[c]),
                       int(jn[c])),
                      N, pose=c < 2)


def test_repeated_indices_weigh_once():
    """Sample sets drawn from few slots repeat indices: each repeated index
    weighs 1 (set, not accumulated), as JAX's `.at[idx].set(1.0)`; the final
    pose still matches JAX's."""
    rng = np.random.default_rng(5)
    sel = rng.integers(0, 8, size=(2, 40, 6))
    valid = rng.uniform(size=(2, 12)) < 0.9
    w = pnp.set_weights(_t(sel), _t(valid)).numpy()
    for c in range(2):
        for s in range(40):
            want = np.asarray(jnp.zeros(12).at[sel[c, s]].set(1.0)) * valid[c]
            np.testing.assert_array_equal(w[c, s], want)
    assert (w <= 1.0).all() and (w.sum(-1) < 6).any()
    X, uv = CASES["clean"]()
    N = len(X)
    sets = pnp.make_pnp_sample_sets(7, 300, seed=2)    # indices 0..6 only
    assert (np.sort(sets, 1)[:, 1:] == np.sort(sets, 1)[:, :-1]).any(1).mean() > 0.9
    valid = np.ones(N, bool)
    _assert_close(_port(X, uv, valid, sets), _jax(X, uv, valid, sets), N)
