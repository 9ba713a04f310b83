"""Motion-only pose optimization (Levenberg-Marquardt on SE3).

Port of orb_slam_system_tpu/solvers/pose_opt.py (reference
Optimizer::PoseOptimization): one SE3 vertex, N monocular and stereo
reprojection edges with information invSigma2*I and Huber kernels
delta = sqrt(5.991) mono / sqrt(7.815) stereo, run as 4 rounds x 10 LM
iterations with chi2 inlier reclassification between rounds; the Huber
kernel is dropped after round 2. Stereo edges (obs_ur >= 0) add the
right-column residual u_r - (u - bf/z).

The loop keeps the LM state (xi, lambda, the accept decision) as tensors:
nothing inside it reads a value back to the host, so on the card the 40
iterations enqueue without a single synchronization.

One LM serves both entry points: it runs over any leading axes of the
inputs. `pose_optimization` solves one pose (no leading axis);
`pose_optimization_batch` solves S independent poses over a leading axis
with one set of launches (the JAX package's jax.vmap in
parallel/multiseq.py:99-103).

The JAX function's `axis_name` psum (JAX pose_opt.py:139, 152-153) is the
`group` argument here: a pose's edges split over the ranks of a
torch.distributed group, its H, g and robust costs summed over them
(utils/collectives.all_sum, nothing when the group is None), so every rank
solves the same pose. The sums run on the [..., 6, 6] / [..., 6] normal
equations and [...] costs of every pose at once, once per iteration
(parallel/multiseq.py's sharded step), since a collective cannot run under
torch.func.vmap.

On the card, without a group, every round of every pose runs in one launch
of the hand-written kernel csrc/pose_lm.cu (`pose_lm`; one thread block a
pose), which the eager loop's 10,644 launches a pose left host-bound. The
eager `_lm` is its plain version: it serves CPU tensors, which the tests
hold against JAX, and any group, whose collectives run between iterations
where a kernel cannot make them.
"""

from __future__ import annotations

import math

import torch

from orb_slam_system_tpu_torch.utils import kernels, lie
from orb_slam_system_tpu_torch.utils.collectives import all_sum
from orb_slam_system_tpu_torch.utils.precision import set_f32_policy

CHI2_MONO = 5.991            # reference src/Optimizer.cc:330
CHI2_STEREO = 7.815          # reference chi2Stereo
HUBER_DELTA_MONO = 2.447731  # sqrt(5.991)
HUBER_DELTA_STEREO = 2.795532  # sqrt(7.815)


def _residuals(xi, T0, Xw, obs, obs_ur, bf, fx, fy, cx, cy, with_jac):
    """e = [obs_uv - pi(X); obs_ur - (u - bf/z)] at pose exp(xi) T0, over
    any leading axes (xi [...,6], T0 [...,4,4], Xw [...,N,3]). Returns
    (e [...,N,3], J [...,N,3,6] or None, z [...,N], is_stereo [...,N])."""
    T = lie.se3_exp(xi) @ T0
    Xc = Xw @ T[..., :3, :3].mT + T[..., None, :3, 3]
    x, y, z = Xc.unbind(-1)
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / zs
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    is_stereo = obs_ur >= 0
    zero = torch.zeros_like(x)
    e = torch.stack([obs[..., 0] - u, obs[..., 1] - v,
                     torch.where(is_stereo, obs_ur - (u - bf * inv_z), zero)],
                    dim=-1)
    if not with_jac:
        return e, None, z, is_stereo
    inv_z2 = inv_z * inv_z
    J_proj = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1),
        torch.stack([fx * inv_z, zero, (-fx * x + bf) * inv_z2], dim=-1),
    ], dim=-2)                                           # d(u,v,ur)/d(Xc)
    neg_hat = torch.stack([
        torch.stack([zero, z, -y], dim=-1),
        torch.stack([-z, zero, x], dim=-1),
        torch.stack([y, -x, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand_as(neg_hat)
    J = -(J_proj @ torch.cat([eye, neg_hat], dim=-1))  # [...,N,3,6]
    # (1, 1, 0) made on the device: a tensor built from a host list would
    # be a blocking host->device copy inside every LM iteration.
    row_mask = (torch.arange(3, device=Xc.device) < 2).to(Xc.dtype)[:, None]
    J = J * torch.where(is_stereo[..., None, None], torch.ones_like(row_mask),
                        row_mask)
    return e, J, z, is_stereo


def _rho(chi2, is_st, use_huber: bool):
    """Robust cost per edge (Huber on chi2 in the first two rounds)."""
    if not use_huber:
        return chi2
    delta = torch.where(is_st, torch.full_like(chi2, HUBER_DELTA_STEREO),
                        torch.full_like(chi2, HUBER_DELTA_MONO))
    huber = 2.0 * delta * torch.sqrt(chi2.clamp_min(1e-12)) - delta * delta
    return torch.where(chi2 > delta * delta, huber, chi2)


def pose_optimization(Tcw0, Xw, obs, inv_sigma2, valid, fx, fy, cx, cy,
                      obs_ur=None, bf=0.0, n_rounds: int = 4,
                      n_iters: int = 10, group=None):
    """Returns (Tcw f32[4,4], inlier bool[N], n_inliers i64 tensor).

    valid marks real correspondences; obs_ur (f32[N], -1 mono) adds stereo
    right-column residuals. Points behind the camera are outliers. With a
    group, this rank's N edges are its share of the pose's (H, g and the
    costs summed over the group); inlier and n_inliers stay this rank's."""
    return _solve(Tcw0, Xw, obs, inv_sigma2, valid, fx, fy, cx, cy, obs_ur,
                  bf, n_rounds, n_iters, group)


def pose_optimization_batch(Tcw0, Xw, obs, inv_sigma2, valid, fx, fy, cx, cy,
                            group=None):
    """pose_optimization of S monocular problems over a leading sequence
    axis: Tcw0 f32[S,4,4], Xw f32[S,N,3], obs f32[S,N,2], inv_sigma2
    f32[S,N], valid bool[S,N] -> (Tcw f32[S,4,4], inlier bool[S,N],
    n_inliers i64[S]). The S solves share one set of launches; row s equals
    pose_optimization on row s up to the reduction order of the batched
    products. With a group, each rank holds its share of every pose's N
    edges (module docstring)."""
    set_f32_policy()
    return _solve(Tcw0, Xw, obs, inv_sigma2, valid, fx, fy, cx, cy, None,
                  0.0, 4, 10, group)


def _takes_kernel(Xw: torch.Tensor, group) -> bool:
    """CUDA tensors without a group take the kernel; the rest `_lm`."""
    return Xw.is_cuda and group is None


def _solve(Tcw0, Xw, obs, inv_sigma2, valid, fx, fy, cx, cy, obs_ur, bf,
           n_rounds: int, n_iters: int, group):
    """The rounds of LM: one `pose_lm` launch, else the eager `_lm`."""
    if not _takes_kernel(Xw, group):
        return _lm(Tcw0, Xw, obs, inv_sigma2, valid, fx, fy, cx, cy, obs_ur,
                   bf, n_rounds, n_iters, group)
    f32 = torch.float32
    return pose_lm(
        Tcw0.to(f32).contiguous(), Xw.to(f32).contiguous(),
        obs.to(f32).contiguous(),
        None if obs_ur is None else obs_ur.to(f32).contiguous(),
        inv_sigma2.to(f32).contiguous(), valid.to(torch.bool).contiguous(),
        fx, fy, cx, cy, bf, n_rounds, n_iters)


def pose_lm(Tcw0, Xw, obs, obs_ur, inv_sigma2, valid, fx, fy, cx, cy, bf=0.0,
            n_rounds: int = 4, n_iters: int = 10):
    """`_lm` without a group in one launch of kernel E (csrc/pose_lm.cu),
    one thread block per pose over the leading axes: Tcw0 f32[...,4,4], Xw
    f32[...,N,3], obs f32[...,N,2], obs_ur f32[...,N] or None (every edge
    monocular), inv_sigma2 f32[...,N], valid bool[...,N], all contiguous on
    one CUDA device -> (Tcw f32[...,4,4], inlier bool[...,N], n_inliers
    i64[...]). Raises on any other input before the library is built."""
    lead = tuple(Tcw0.shape[:-2])
    L = len(lead)
    args = [(Tcw0, "Tcw0", torch.float32, L + 2),
            (Xw, "Xw", torch.float32, L + 2),
            (obs, "obs", torch.float32, L + 2),
            (inv_sigma2, "inv_sigma2", torch.float32, L + 1),
            (valid, "valid", torch.bool, L + 1)]
    if obs_ur is not None:
        args.append((obs_ur, "obs_ur", torch.float32, L + 1))
    for t, name, dtype, ndim in args:
        kernels.check_cuda(t, f"pose_lm {name}", dtype, ndim)
    N = Xw.shape[-2]
    want = {"Tcw0": lead + (4, 4), "Xw": lead + (N, 3), "obs": lead + (N, 2),
            "obs_ur": lead + (N,), "inv_sigma2": lead + (N,),
            "valid": lead + (N,)}
    for t, name, _dtype, _ndim in args:
        if tuple(t.shape) != want[name] or t.device != Tcw0.device:
            raise ValueError(f"pose_lm: {name} {tuple(t.shape)} on {t.device};"
                             f" expected {want[name]} on {Tcw0.device}")
    if n_rounds < 0 or n_iters < 0:
        raise ValueError(f"pose_lm: {n_rounds} rounds of {n_iters} iterations")
    T = torch.empty_like(Tcw0)
    inlier = torch.empty(lead + (N,), dtype=torch.bool, device=Xw.device)
    n_in = torch.empty(lead, dtype=torch.int64, device=Xw.device)
    kernels.launch("orb_pose_lm", "pose_lm", Tcw0.data_ptr(), Xw.data_ptr(),
                   obs.data_ptr(),
                   None if obs_ur is None else obs_ur.data_ptr(),
                   inv_sigma2.data_ptr(), valid.data_ptr(), T.data_ptr(),
                   inlier.data_ptr(), n_in.data_ptr(), math.prod(lead), N,
                   int(n_rounds), int(n_iters), float(fx), float(fy),
                   float(cx), float(cy), float(bf), CHI2_MONO, CHI2_STEREO,
                   HUBER_DELTA_MONO, HUBER_DELTA_STEREO)
    return T, inlier, n_in


def _lm(Tcw0, Xw, obs, inv_sigma2, valid, fx, fy, cx, cy, obs_ur, bf,
        n_rounds: int, n_iters: int, group):
    """The rounds of LM over the leading axes of Tcw0 [...,4,4] (module
    docstring); obs_ur None is every edge monocular."""
    f32 = torch.float32
    dev = Xw.device
    Xw, obs, T0 = Xw.to(f32), obs.to(f32), Tcw0.to(f32)
    lead = T0.shape[:-2]
    if obs_ur is None:
        obs_ur = torch.full(Xw.shape[:-1], -1.0, dtype=f32, device=dev)
    obs_ur = obs_ur.to(f32)
    inlier = valid
    eye6 = torch.eye(6, dtype=f32, device=dev)
    args = (Xw, obs, obs_ur, bf, fx, fy, cx, cy)
    for r in range(n_rounds):
        use_huber = r < 2  # reference drops the kernel after round 2 (:393)
        xi = torch.zeros(lead + (6,), dtype=f32, device=dev)
        lam = torch.full(lead, 1e-4, dtype=f32, device=dev)
        for _ in range(n_iters):
            e, J, z, is_st = _residuals(xi, T0, *args, with_jac=True)
            chi2 = (e * e).sum(dim=-1) * inv_sigma2
            active = inlier & (z > 0)
            if use_huber:
                delta = torch.where(is_st,
                                    torch.full_like(chi2, HUBER_DELTA_STEREO),
                                    torch.full_like(chi2, HUBER_DELTA_MONO))
                w_h = torch.clamp_max(delta / torch.sqrt(chi2.clamp_min(1e-12)),
                                      1.0)
            else:
                w_h = torch.ones_like(chi2)
            w = torch.where(active, w_h * inv_sigma2, torch.zeros_like(chi2))
            H = all_sum(torch.einsum("...n,...nif,...nig->...fg", w, J, J),
                        group)
            g = all_sum(torch.einsum("...n,...nif,...ni->...f", w, J, e),
                        group)
            A = (H + lam[..., None, None]
                 * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
                 + 1e-9 * eye6)
            dx = torch.linalg.solve_ex(A, -g)[0]
            zero = torch.zeros_like(chi2)
            cost0 = all_sum(torch.where(active, _rho(chi2, is_st, use_huber),
                                        zero).sum(dim=-1), group)
            e1, _, z1, _ = _residuals(xi + dx, T0, *args, with_jac=False)
            chi2_1 = (e1 * e1).sum(dim=-1) * inv_sigma2
            cost1 = all_sum(torch.where(inlier & (z1 > 0),
                                        _rho(chi2_1, is_st, use_huber),
                                        zero).sum(dim=-1), group)
            improved = cost1 < cost0
            xi = torch.where(improved[..., None], xi + dx, xi)
            lam = torch.where(improved, lam * 0.5, lam * 4.0).clamp(1e-10, 1e6)
        T0 = lie.se3_exp(xi) @ T0
        # Reclassify: raw chi2 against the 95% gates.
        e, _, z, is_st = _residuals(torch.zeros_like(xi), T0, *args,
                                    with_jac=False)
        chi2 = (e * e).sum(dim=-1) * inv_sigma2
        gate = torch.where(is_st, torch.full_like(chi2, CHI2_STEREO),
                           torch.full_like(chi2, CHI2_MONO))
        inlier = valid & (z > 0) & (chi2 <= gate)
    return T0, inlier, inlier.sum(dim=-1)
