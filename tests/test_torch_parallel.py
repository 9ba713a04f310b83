"""The port's sharded solvers over torch.distributed on the CPU (gloo),
against the port's unsharded solves and the JAX package's sharded ones
(parallel/ba_dist.py, parallel/pose_graph_dist.py, parallel/multiseq.py).

One spawn of 2 ranks and one of 4 (tests/torch_parallel_ranks.py, a module
without jax, runs in each rank); every check of a world size reads that
spawn's results. Tolerances: the sharded global BA within 1e-3 of the
port's unsharded solve and of JAX's bundle_adjust_cg_sharded over a mesh of
the same size, its reprojection RMS below 0.7x the start
(tests/test_pose_graph_dist.py's bars); the sharded essential graph within
2e-3 of both; every rank's result equal to rank 0's bit for bit; the dp x
sp step at 4 ranks on a tracked state (hundreds of matches) with totals
equal to the port's unsharded step and JAX's make_mesh(4) step and poses
within 1e-4 of both (tests/test_parallel.py's tolerance); dryrun(2)
passing, its step's totals the same on both ranks; each solver with
group=None bit-equal to the same solver over a group of one rank.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orb_slam_system_tpu.parallel.ba_dist import (
    bundle_adjust_cg_sharded as j_ba_sharded)
from orb_slam_system_tpu.parallel.multiseq import (
    make_mesh as j_make_mesh, make_multiseq_step as j_make_step)
from orb_slam_system_tpu.parallel.pose_graph_dist import (
    optimize_essential_graph_sharded as j_eg_sharded)
from orb_slam_system_tpu.solvers.local_ba import BAProblem as JBAProblem
from orb_slam_system_tpu_torch.parallel import multiseq
from orb_slam_system_tpu_torch.parallel.ba_dist import bundle_adjust_cg_sharded
from orb_slam_system_tpu_torch.parallel.launch import spawn_ranks
from orb_slam_system_tpu_torch.parallel.pose_graph_dist import (
    optimize_essential_graph_sharded)
from orb_slam_system_tpu_torch.solvers.local_ba import bundle_adjust_cg
from orb_slam_system_tpu_torch.solvers.pose_graph import (
    optimize_essential_graph)
from orb_slam_system_tpu_torch.utils.lie import se3_exp

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks as ranks  # noqa: E402

C, P = 6, 61          # 366 edges: padded at 4 ranks
K = 13                # 13 edges: padded at 2 and 4 ranks
FX = FY = 300.0
CX, CY = 160.0, 120.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module, as the other port test files;
    every spawned rank runs on one thread too (parallel/launch.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems():
    """The JAX sharded tests' global-BA and essential-graph problems, from
    default_rng(0), as numpy arrays."""
    rng = np.random.default_rng(0)
    world = rng.uniform(-2, 2, size=(P, 3)).astype(np.float32)
    world[:, 2] = rng.uniform(4, 8, size=P)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    for c in range(C):
        Tcw[c, 0, 3] = -0.2 * c + (rng.normal() * 0.02 if c else 0.0)
    uv = []
    for c in range(C):
        Xc = world @ Tcw[c, :3, :3].T + Tcw[c, :3, 3]
        u = Xc[:, :2] / Xc[:, 2:3] * [FX, FY] + [CX, CY]
        uv.append(u + rng.normal(scale=0.3, size=u.shape))
    E = C * P
    z = dict(
        ba_Tcw=Tcw, ba_cam_fixed=np.arange(C) == 0,
        ba_cam_valid=np.ones(C, bool),
        ba_points=world + rng.normal(scale=0.03, size=world.shape).astype(
            np.float32),
        ba_pt_valid=np.ones(P, bool), ba_e_cam=np.repeat(np.arange(C), P),
        ba_e_pt=np.tile(np.arange(P), C),
        ba_e_uv=np.concatenate(uv).astype(np.float32),
        ba_e_inv_sigma2=np.ones(E, np.float32), ba_e_valid=np.ones(E, bool),
        ba_intrinsics=np.array([FX, FY, CX, CY]))

    def pose(k):
        ang = 2 * np.pi * k / K
        xi = np.array([0.5 * np.sin(ang), 0.0, 0.5 * (1 - np.cos(ang)),
                       0.0, ang, 0.0], np.float32)
        return se3_exp(torch.from_numpy(xi)).numpy()
    T_true = [pose(k) for k in range(K)]
    T_est = [T_true[0]]
    for k in range(1, K):
        rel = T_true[k] @ np.linalg.inv(T_true[k - 1])
        noise = se3_exp(torch.from_numpy(
            (rng.normal(size=6) * 0.02).astype(np.float32))).numpy()
        T_est.append(noise @ rel @ T_est[-1])
    edges = [(k, k + 1, T_est[k], T_est[k + 1]) for k in range(K - 1)]
    edges.append((K - 1, 0, T_true[K - 1], T_true[0]))
    rels = [Tj @ np.linalg.inv(Ti) for _, _, Ti, Tj in edges]
    z.update(
        eg_R0=np.stack([T[:3, :3] for T in T_est]).astype(np.float32),
        eg_t0=np.stack([T[:3, 3] for T in T_est]).astype(np.float32),
        eg_s0=np.ones(K, np.float32), eg_fixed=np.arange(K) == 0,
        eg_valid=np.ones(K, bool),
        eg_e_i=np.array([e[0] for e in edges]),
        eg_e_j=np.array([e[1] for e in edges]),
        eg_e_R=np.stack([r[:3, :3] for r in rels]).astype(np.float32),
        eg_e_t=np.stack([r[:3, 3] for r in rels]).astype(np.float32),
        eg_e_s=np.ones(len(edges), np.float32),
        eg_e_valid=np.ones(len(edges), bool))
    return z


@pytest.fixture(scope="module")
def problems():
    return _problems()


def _spawn(world, problems, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(f"ranks{world}"))
    np.savez(os.path.join(d, "problems.npz"), **problems)
    spawn_ranks(ranks.rank_checks, world, "gloo", d)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def spawned(problems, tmp_path_factory):
    """{world: [rank results]} for one spawn each of 2 and 4 gloo ranks."""
    return {w: _spawn(w, problems, tmp_path_factory) for w in (2, 4)}


def _jax_mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("graph",))


def _j_ba(z):
    return JBAProblem(**{k: jnp.asarray(z["ba_" + k].astype(np.int32)
                                        if k in ("e_cam", "e_pt")
                                        else z["ba_" + k]) for k in (
        "Tcw", "cam_fixed", "cam_valid", "points", "pt_valid", "e_cam",
        "e_pt", "e_uv", "e_inv_sigma2", "e_valid")})


def _rms(z, T, X):
    T, X = np.asarray(T), np.asarray(X)
    c, p = z["ba_e_cam"], z["ba_e_pt"]
    Xc = np.einsum("eij,ej->ei", T[c, :3, :3], X[p]) + T[c, :3, 3]
    u = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX,
                  FY * Xc[:, 1] / Xc[:, 2] + CY], 1)
    return float(np.sqrt(np.mean(np.sum((u - z["ba_e_uv"]) ** 2, 1))))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ba_matches_unsharded_and_jax(world, spawned, problems):
    z = problems
    T, X = (t.numpy() for t in spawned[world][0]["ba"])
    T1, X1 = bundle_adjust_cg(ranks.ba_problem(z), FX, FY, CX, CY,
                              n_iters=ranks.BA_ITERS, cg_iters=ranks.BA_CG)
    np.testing.assert_allclose(T, T1.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(X, X1.numpy(), rtol=1e-3, atol=1e-3)
    Tj, Xj = j_ba_sharded(_jax_mesh(world), _j_ba(z), FX, FY, CX, CY,
                          n_iters=ranks.BA_ITERS, cg_iters=ranks.BA_CG)
    np.testing.assert_allclose(T, np.asarray(Tj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(X, np.asarray(Xj), rtol=1e-3, atol=1e-3)
    assert _rms(z, T, X) < 0.7 * _rms(z, z["ba_Tcw"], z["ba_points"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_essential_graph_matches_unsharded_and_jax(world, spawned,
                                                           problems):
    got = [t.numpy() for t in spawned[world][0]["eg"]]
    ref = optimize_essential_graph(*ranks.eg_args(problems),
                                   n_iters=ranks.EG_ITERS,
                                   cg_iters=ranks.EG_CG)
    j_args = [problems["eg_" + k] for k in (
        "R0", "t0", "s0", "fixed", "valid")] + [
        problems["eg_" + k].astype(np.int32) for k in ("e_i", "e_j")] + [
        problems["eg_" + k] for k in ("e_R", "e_t", "e_s", "e_valid")]
    jref = j_eg_sharded(_jax_mesh(world), *j_args, n_iters=ranks.EG_ITERS,
                        cg_iters=ranks.EG_CG)
    for a, b, c in zip(got, ref, jref):
        np.testing.assert_allclose(a, b.numpy(), atol=2e-3)
        np.testing.assert_allclose(a, np.asarray(c), atol=2e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_returns_the_same_result(world, spawned):
    """The sums make every rank's solve the same: bit for bit, and no rank
    imported jax or the JAX package."""
    r0 = spawned[world][0]
    for r in spawned[world]:
        assert not r["jax_imported"]
        for key in ("ba", "eg"):
            for a, b in zip(r[key], r0[key]):
                assert torch.equal(a, b), key


def test_mesh_step_matches_jax(spawned):
    """The dp x sp step at 4 ranks (dp 2, mp 2) on a tracked state of the
    JAX example's images (multiseq.tracked_args: every valid keypoint
    matches, a tenth are outliers, and each rank's half of the edges alone
    solves to another pose), against the port's unsharded step and JAX's
    make_mesh(4) step on the same state."""
    h, w, nf, nl = ranks.MESH_SHAPE
    step1, args1 = multiseq.make_multiseq_step(h, w, n_features=nf,
                                               n_levels=nl, n_sequences=4,
                                               device="cpu")
    state = multiseq.tracked_args(args1[0], nf, nl)
    T1, n_in1, n_match1 = (t.numpy() for t in step1(*state))
    jstep, _ = j_make_step(j_make_mesh(4), h, w, n_features=nf, n_levels=nl)
    j_state = [a.numpy() for a in state]
    j_state[1] = j_state[1].view(np.uint32)
    Tj, n_inj, n_matchj = (np.asarray(a) for a in jstep(*j_state))
    assert int(n_match1) >= 300 and 0.8 * n_match1 <= n_in1 < n_match1
    assert (int(n_inj), int(n_matchj)) == (int(n_in1), int(n_match1))
    np.testing.assert_allclose(T1, Tj, rtol=1e-4, atol=1e-4)
    got = spawned[4]
    assert {(r["mesh"]["d"], r["mesh"]["m"]) for r in got} == {
        (0, 0), (0, 1), (1, 0), (1, 1)}
    for rank, r in enumerate(got):
        m = r["mesh"]
        assert m["shape"] == {"data": 2, "model": 2}
        assert divmod(rank, 2) == (m["d"], m["m"])
        assert (m["n_in"], m["n_match"]) == (int(n_in1), int(n_match1))
        rows = slice(2 * m["d"], 2 * m["d"] + 2)
        np.testing.assert_allclose(m["T"].numpy(), T1[rows], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(m["T"].numpy(), Tj[rows], rtol=1e-4,
                                   atol=1e-4)


def test_dryrun_two_ranks(spawned):
    n_in, n_match = spawned[2][0]["dryrun"]
    assert spawned[2][1]["dryrun"] == (n_in, n_match)
    # dp 1 x mp 2: two sequences of up to 128 keypoints, all matched.
    assert 150 <= n_match <= 256 and n_in >= 0.8 * n_match


@pytest.mark.parametrize("solver", ["bundle_adjust_cg",
                                    "optimize_essential_graph",
                                    "pose_optimization",
                                    "pose_optimization_batch"])
def test_group_none_bit_equal_to_one_rank_group(solver, spawned):
    for r in spawned[2]:
        unsharded, one = r["group_one"][solver]
        for a, b in zip(unsharded, one):
            assert torch.equal(a, b), solver


def test_sharded_solvers_raise_without_a_group(problems):
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        bundle_adjust_cg_sharded(ranks.ba_problem(problems), FX, FY, CX, CY)
    with pytest.raises(RuntimeError, match="process group"):
        optimize_essential_graph_sharded(*ranks.eg_args(problems))


def test_rank_worker_imports_no_jax():
    """The rank worker, imported alone in a fresh interpreter, brings in
    neither jax nor the JAX package."""
    code = ("import sys; sys.path.insert(0, 'tests');"
            "import torch_parallel_ranks;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'orb_slam_system_tpu')]; assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
