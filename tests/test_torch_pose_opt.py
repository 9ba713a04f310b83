"""Port pose_optimization (4 rounds x 10 LM) against the JAX package on
the CPU: the same numpy edges into both. Tolerance: pose atol 1e-4 and
equal inlier masks.

tests/golden/pose_lm_jax.npz holds the JAX package's answers on three
problems (mono, stereo, a batch of five), which tests/test_torch_cuda.py
holds the CUDA kernel against on the card, where JAX is not installed.
test_jax_reference_file keeps the file equal to what JAX gives; to write it
anew, from the repository root:
PYTHONPATH=. JAX_PLATFORMS=cpu JAX_PLATFORM_NAME=cpu \
    python tests/test_torch_pose_opt.py"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.solvers.pose_opt import pose_optimization as j_pose_opt
from orb_slam_system_tpu_torch.solvers.pose_opt import (
    pose_optimization, pose_optimization_batch)
from orb_slam_system_tpu_torch.utils.lie import se3_exp

FX = FY = 500.0
CX, CY = 320.0, 240.0
BF = 40.0


def _problem(rng, stereo: bool, N: int = 160, n_out: int = 20):
    X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                  rng.uniform(4, 10, N)], axis=1).astype(np.float32)
    T_true = se3_exp(torch.from_numpy(
        (rng.normal(size=6) * [0.2, 0.2, 0.2, 0.05, 0.05, 0.05]).astype(np.float32))).numpy()
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX,
                   FY * Xc[:, 1] / Xc[:, 2] + CY], axis=1)
    uv = (uv + rng.normal(size=uv.shape) * 0.5).astype(np.float32)
    out = rng.choice(N, size=n_out, replace=False)
    uv[out] += rng.uniform(20, 80, size=(n_out, 2)).astype(np.float32)
    ur = np.full(N, -1.0, np.float32)
    if stereo:
        st = rng.uniform(size=N) < 0.5
        ur[st] = (uv[st, 0] - BF / Xc[st, 2]
                  + rng.normal(size=st.sum()) * 0.5).astype(np.float32)
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, N))).astype(np.float32)
    valid = rng.uniform(size=N) < 0.95
    dxi = (rng.normal(size=6) * 0.03).astype(np.float32)
    T0 = (se3_exp(torch.from_numpy(dxi)).numpy() @ T_true).astype(np.float32)
    return T0, X, uv, inv_s2, valid, ur, T_true


@pytest.mark.parametrize("stereo", [False, True])
def test_pose_optimization_matches_jax(stereo, rng):
    T0, X, uv, inv_s2, valid, ur, T_true = _problem(rng, stereo)
    Tj, inl_j, n_j = j_pose_opt(jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv),
                                jnp.asarray(inv_s2), jnp.asarray(valid),
                                FX, FY, CX, CY, obs_ur=jnp.asarray(ur), bf=BF)
    t = torch.from_numpy
    Tp, inl_p, n_p = pose_optimization(t(T0), t(X), t(uv), t(inv_s2), t(valid),
                                       FX, FY, CX, CY, obs_ur=t(ur), bf=BF)
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl_p.numpy(), np.asarray(inl_j))
    assert int(n_p) == int(n_j)
    # And it actually solved the problem.
    np.testing.assert_allclose(Tp.numpy(), T_true, atol=2e-2)


# ---- dispatch: the CUDA kernel (csrc/pose_lm.cu) against the eager LM ----

def _no_build(monkeypatch):
    """Make any build or load of the kernel library fail the test."""
    from orb_slam_system_tpu_torch.utils import kernels

    def refuse(*_a, **_k):
        raise AssertionError("the kernel library was built or loaded")
    monkeypatch.setattr(kernels, "build", refuse)
    monkeypatch.setattr(kernels, "library", refuse)
    return kernels


@pytest.mark.parametrize("entry", ["single", "batch"])
def test_cpu_tensors_take_the_eager_lm(entry, rng, monkeypatch):
    """CPU tensors run the eager `_lm` bit for bit: the kernel library is
    never built and the pose_lm counter does not move."""
    from orb_slam_system_tpu_torch.solvers import pose_opt
    kernels = _no_build(monkeypatch)
    T0, X, uv, inv_s2, valid, ur, _ = _problem(rng, entry == "single")
    t = torch.from_numpy
    before = kernels.LAUNCHES["pose_lm"]
    if entry == "single":
        got = pose_optimization(t(T0), t(X), t(uv), t(inv_s2), t(valid),
                                FX, FY, CX, CY, obs_ur=t(ur), bf=BF)
        want = pose_opt._lm(t(T0), t(X), t(uv), t(inv_s2), t(valid), FX, FY,
                            CX, CY, t(ur), BF, 4, 10, None)
    else:
        args = [t(np.stack([a, a])) for a in (T0, X, uv, inv_s2, valid)]
        got = pose_opt.pose_optimization_batch(*args, FX, FY, CX, CY)
        want = pose_opt._lm(*args, FX, FY, CX, CY, None, 0.0, 4, 10, None)
    assert kernels.LAUNCHES["pose_lm"] == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


class _CudaLike:
    """Stands in for a CUDA tensor in the dispatch predicate."""
    is_cuda = True


@pytest.mark.parametrize("on_card,with_group,kernel", [
    (True, False, True), (True, True, False),
    (False, False, False), (False, True, False)])
def test_dispatch_kernel_only_on_the_card_without_a_group(on_card, with_group,
                                                          kernel):
    """The kernel serves CUDA tensors without a group; a group (its
    collectives run between iterations) or a CPU tensor keeps `_lm`."""
    from orb_slam_system_tpu_torch.solvers import pose_opt
    Xw = _CudaLike() if on_card else torch.zeros(4, 3)
    group = object() if with_group else None
    assert pose_opt._takes_kernel(Xw, group) is kernel


@pytest.mark.parametrize("fault", ["cpu", "float64", "non_contiguous",
                                   "shape", "valid_dtype"])
def test_pose_lm_wrapper_rejects_before_any_build(fault, rng, monkeypatch):
    """The wrapper refuses a CPU, wrong-dtype, non-contiguous or misshapen
    input with ValueError / TypeError before the library is built."""
    from orb_slam_system_tpu_torch.solvers import pose_opt
    kernels = _no_build(monkeypatch)
    T0, X, uv, inv_s2, valid, ur, _ = _problem(rng, True)
    t = torch.from_numpy
    args = dict(Tcw0=t(T0), Xw=t(X), obs=t(uv), obs_ur=t(ur),
                inv_sigma2=t(inv_s2), valid=t(valid))
    if fault == "float64":
        args["Xw"] = args["Xw"].double()
    elif fault == "non_contiguous":
        args["obs"] = torch.from_numpy(np.repeat(uv, 2, axis=1))[:, ::2]
    elif fault == "shape":
        args["inv_sigma2"] = args["inv_sigma2"][:-1]
    elif fault == "valid_dtype":
        args["valid"] = args["valid"].to(torch.uint8)
    before = kernels.LAUNCHES["pose_lm"]
    with pytest.raises((ValueError, TypeError)):
        pose_opt.pose_lm(**args, fx=FX, fy=FY, cx=CX, cy=CY, bf=BF)
    assert kernels.LAUNCHES["pose_lm"] == before


# ---- the JAX reference that the kernel on the card is held against ----

REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "golden", "pose_lm_jax.npz")
REFERENCE_CASES = ("mono", "stereo", "batch5")
_INPUTS = ("T0", "Xw", "obs", "inv_sigma2", "valid", "obs_ur")


def _reference_inputs(case: str) -> dict:
    """A reference case's numpy inputs: one pose of 160 edges (mono, or
    half the edges stereo), or five poses of 1,024 monocular edges with 100
    outliers each (no obs_ur, as pose_optimization_batch takes them)."""
    rng = np.random.default_rng({"mono": 11, "stereo": 12, "batch5": 13}[case])
    if case == "batch5":
        probs = [_problem(rng, False, 1024, 100)[:5] for _ in range(5)]
        return dict(zip(_INPUTS, (np.stack(a) for a in zip(*probs))))
    return dict(zip(_INPUTS, _problem(rng, case == "stereo")[:6]))


def _jax_answer(p: dict):
    """The JAX package's (T, inlier, n_inliers) on a case's inputs, a pose
    at a time."""
    batch = p["T0"].ndim == 3
    outs = []
    for s in range(len(p["T0"]) if batch else 1):
        q = {k: (v[s] if batch else v) for k, v in p.items()}
        extra = ({} if batch else dict(obs_ur=jnp.asarray(q["obs_ur"]), bf=BF))
        outs.append([np.asarray(o) for o in j_pose_opt(
            jnp.asarray(q["T0"]), jnp.asarray(q["Xw"]), jnp.asarray(q["obs"]),
            jnp.asarray(q["inv_sigma2"]), jnp.asarray(q["valid"]),
            FX, FY, CX, CY, **extra)])
    T, inl, n = (np.stack(a) if batch else a[0] for a in zip(*outs))
    return T, inl, n.astype(np.int64)


def write_reference(path: str = REFERENCE) -> None:
    """Write every reference case's inputs and JAX answer to `path`."""
    arrays = {}
    for case in REFERENCE_CASES:
        p = _reference_inputs(case)
        arrays.update({f"{case}.{k}": v for k, v in p.items()})
        for k, v in zip(("T", "inlier", "n_inliers"), _jax_answer(p)):
            arrays[f"{case}.{k}"] = v
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_jax_reference_file(case):
    """The golden file holds this module's problem and the JAX package's
    answer to it, and the port's eager LM on the CPU meets that answer at
    the module's tolerance: pose atol 1e-4, equal inlier masks and
    counts."""
    with np.load(REFERENCE) as f:
        ref = {k.split(".", 1)[1]: f[k] for k in f.files
               if k.startswith(case + ".")}
    p = _reference_inputs(case)
    assert set(ref) == set(p) | {"T", "inlier", "n_inliers"}
    for k, v in p.items():
        np.testing.assert_allclose(ref[k], v, rtol=0, atol=1e-6)
    p = {k: ref[k] for k in p}
    T, inl, n = _jax_answer(p)
    np.testing.assert_allclose(ref["T"], T, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ref["inlier"], inl)
    np.testing.assert_array_equal(ref["n_inliers"], n)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    args = [t[k] for k in _INPUTS[:5]] + [FX, FY, CX, CY]
    if case == "batch5":
        Tp, inl_p, n_p = pose_optimization_batch(*args)
    else:
        Tp, inl_p, n_p = pose_optimization(*args, obs_ur=t["obs_ur"], bf=BF)
    np.testing.assert_allclose(Tp.numpy(), ref["T"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl_p.numpy(), ref["inlier"])
    np.testing.assert_array_equal(n_p.numpy(), ref["n_inliers"])


if __name__ == "__main__":
    write_reference()
