"""Sim3 pose-graph (essential graph) optimization + loop Sim3 refinement.

Port of orb_slam_system_tpu/solvers/pose_graph.py (reference
Optimizer::OptimizeEssentialGraph: Sim3 vertices over all keyframes, loop /
spanning-tree / covisibility edges, 20 LM iterations; and
Optimizer::OptimizeSim3: one Sim3 vertex with paired forward/inverse
projection edges, two stages with outlier removal).

  * Per-edge residuals are batched over the edges; their exact Jacobians
    come from forward-mode AD (torch.func.jvp under torch.func.vmap over
    the 14 tangent directions: each edge's residual depends only on its own
    two vertices, so one tangent per direction, shared by all edges, gives
    that column of every edge's Jacobian). The JAX package takes the same
    Jacobians with vmap(jacfwd) per edge.
  * The sparse normal equations are solved by preconditioned CG whose
    matvec is two segment sums over the edge list, preconditioned by the
    inverted 7x7 diagonal blocks. Segment sums accumulate in a fixed order
    (local_ba._seg_sum), so the solve is the same every run.
  * The LM and CG loops are Python loops of tensor ops; accept/reject is
    chosen on the device, so the solve syncs with the host only at its end.
"""

from __future__ import annotations

import torch
from torch.func import jvp, vmap

from orb_slam_system_tpu_torch.solvers.local_ba import _seg_sum
from orb_slam_system_tpu_torch.solvers.sim3 import _project
from orb_slam_system_tpu_torch.utils import lie
from orb_slam_system_tpu_torch.utils.collectives import all_sum

TH2_SIM3 = 10.0   # OptimizeSim3's chi2 gate (reference ComputeSim3's th2)
SIM3_ITERS = 10   # OptimizeSim3's LM iterations per stage


def _edge_residual(xi_i, xi_j, S0_i, S0_j, Sji):
    """e = log( Sji (exp(xi_i) S0_i) (exp(xi_j) S0_j)^-1 )  [E, 7]."""
    Si = lie.sim3_mul(lie.sim3_exp(xi_i), S0_i)
    Sj = lie.sim3_mul(lie.sim3_exp(xi_j), S0_j)
    return lie.sim3_log(lie.sim3_mul(Sji, lie.sim3_mul(Si, lie.sim3_inv(Sj))))


def _jacobians(f, primals):
    """Jacobians of f (batched over a leading axis, row e depending only on
    row e of each primal) with respect to each primal [E, n_k]: one
    forward-mode pass per tangent direction, all in one vmap."""
    sizes = [p.shape[-1] for p in primals]
    n = sum(sizes)
    eye = torch.eye(n, dtype=primals[0].dtype, device=primals[0].device)
    basis = eye[:, None, :].expand((n,) + primals[0].shape[:-1] + (n,))

    def column(v):
        return jvp(f, tuple(primals), tuple(torch.split(v, sizes, -1)))[1]

    J = vmap(column)(basis).movedim(0, -1)          # [E, m, n]
    return torch.split(J, sizes, -1)


def optimize_essential_graph(R0, t0, s0, v_fixed, v_valid, e_i, e_j,
                             e_R, e_t, e_s, e_valid, n_iters: int = 20,
                             cg_iters: int = 50, group=None):
    """R0 f32[K,3,3], t0 f32[K,3], s0 f32[K]: initial Sim3s (world->cam);
    v_fixed, v_valid bool[K]; e_i, e_j i64[E] vertex indices; e_R, e_t, e_s
    the measurement Sji per edge; e_valid bool[E]. Returns the optimized
    (R f32[K,3,3], t f32[K,3], s f32[K]).

    group: a torch.distributed group over whose ranks the edge list is
    split (vertices replicated; parallel/pose_graph_dist.py). The gradient
    b, the block-Jacobi diagonal, the PCG matvec and the LM costs are
    summed over it where the JAX solver psums them (JAX pose_graph.py:98,
    103, 113), so every rank takes the same steps. None: one process."""
    K = R0.shape[0]
    f32 = t0.dtype
    dev = t0.device
    free = (v_valid & ~v_fixed)[:, None].to(f32)
    S0_i = {"R": R0[e_i], "t": t0[e_i], "s": s0[e_i]}
    S0_j = {"R": R0[e_j], "t": t0[e_j], "s": s0[e_j]}
    Sji = {"R": e_R, "t": e_t, "s": e_s}
    ew = e_valid.to(f32)[:, None]
    eye7 = torch.eye(7, dtype=f32, device=dev)

    def residuals(a, b):
        return _edge_residual(a, b, S0_i, S0_j, Sji)

    def gn_step(xi, lam):
        xa, xb = xi[e_i], xi[e_j]
        r = residuals(xa, xb) * ew                           # [E,7]
        Ji, Jj = _jacobians(residuals, (xa, xb))             # [E,7,7] each
        Ji = Ji * ew[..., None]
        Jj = Jj * ew[..., None]
        JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
        b = all_sum(-(_seg_sum(e_i, (JiT @ r[..., None])[..., 0], K)
                      + _seg_sum(e_j, (JjT @ r[..., None])[..., 0], K)),
                    group) * free
        Hd = (all_sum(_seg_sum(e_i, JiT @ Ji, K) + _seg_sum(e_j, JjT @ Jj, K),
                      group)
              + (lam + 1e-6) * eye7)
        Minv = torch.linalg.inv(Hd)

        def matvec(x):
            x = x * free
            u = (Ji @ x[e_i][..., None] + Jj @ x[e_j][..., None])   # [E,7,1]
            y = all_sum(_seg_sum(e_i, (JiT @ u)[..., 0], K)
                        + _seg_sum(e_j, (JjT @ u)[..., 0], K), group)
            return (y + (lam + 1e-6) * x) * free

        def precond(x):
            return (Minv @ x[..., None])[..., 0] * free

        # PCG from zero.
        x = torch.zeros((K, 7), dtype=f32, device=dev)
        r_cg = b
        z = precond(r_cg)
        p = z
        rz = (r_cg * z).sum()
        for _ in range(cg_iters):
            Ap = matvec(p)
            denom = (p * Ap).sum()
            alpha = rz / torch.where(denom.abs() < 1e-12,
                                     torch.full_like(denom, 1e-12), denom)
            x = x + alpha * p
            r_cg = r_cg - alpha * Ap
            z = precond(r_cg)
            rz_new = (r_cg * z).sum()
            beta = rz_new / torch.where(rz.abs() < 1e-12,
                                        torch.full_like(rz, 1e-12), rz)
            p = z + beta * p
            rz = rz_new
        return x, all_sum((r * r).sum(), group)

    # Reference uses lambdaInit = 1e-16 (:781): effectively pure GN.
    xi = torch.zeros((K, 7), dtype=f32, device=dev)
    lam = torch.tensor(1e-10, dtype=f32, device=dev)
    for _ in range(n_iters):
        dx, cost0 = gn_step(xi, lam)
        xi_new = xi + dx
        cost1 = all_sum(
            ((residuals(xi_new[e_i], xi_new[e_j]) * ew) ** 2).sum(), group)
        improved = cost1 < cost0
        xi = torch.where(improved, xi_new, xi)
        lam = torch.where(improved, lam * 0.5, lam * 4.0).clamp(1e-10, 1e6)
    S = lie.sim3_mul(lie.sim3_exp(xi), {"R": R0, "t": t0, "s": s0})
    keep = free[:, 0] > 0
    return (torch.where(keep[:, None, None], S["R"], R0),
            torch.where(keep[:, None], S["t"], t0),
            torch.where(keep, S["s"], s0))


# ---- OptimizeSim3: refine one loop Sim3 with paired projection edges -------------


def optimize_sim3(s0, R0, t0, P1, P2, uv1, uv2, inv_sigma2_1, inv_sigma2_2,
                  valid, fx, fy, cx, cy, fix_scale: bool = False):
    """Reference Optimizer::OptimizeSim3: minimize the forward (P2 -> image
    1) and inverse (P1 -> image 2) reprojection over S12 (s0 [], R0 [3,3],
    t0 [3]; maps KF2 camera points into KF1's frame), the scale free or,
    with fix_scale, held at s0 (the LM step's scale component is zeroed),
    Huber sqrt(TH2_SIM3), SIM3_ITERS LM iterations; drop the chi2 > TH2_SIM3
    edges after a first pass and re-optimize from its optimum.
    P1, P2 f32[N,3] camera-frame points, uv1, uv2 f32[N,2], inv_sigma2_*
    f32[N], valid bool[N]. Returns (n_inliers, s, R, t, inlier bool[N])."""
    f32 = P1.dtype
    dev = P1.device
    th2 = TH2_SIM3
    delta = th2 ** 0.5
    sq1 = torch.sqrt(inv_sigma2_1)[:, None]
    sq2 = torch.sqrt(inv_sigma2_2)[:, None]

    def residuals(xi, S_base):
        # xi [1, 7]: a one-row batch keeps every intermediate at least 1-D.
        S = lie.sim3_mul(lie.sim3_exp(xi), S_base)
        e1 = uv1 - _project(lie.sim3_apply(S, P2), fx, fy, cx, cy)[0]
        e2 = uv2 - _project(lie.sim3_apply(lie.sim3_inv(S), P1),
                            fx, fy, cx, cy)[0]
        return e1, e2

    def chi2s(xi, S_base):
        e1, e2 = residuals(xi, S_base)
        return (e1 * e1).sum(1) * inv_sigma2_1, (e2 * e2).sum(1) * inv_sigma2_2

    def run(active, S_base):
        aw = active.to(f32)

        def huber(c):
            return torch.where(
                c > th2, 2.0 * delta * torch.sqrt(c.clamp_min(1e-12)) - th2, c)

        def robust_cost(xi):
            c1, c2 = chi2s(xi, S_base)
            return ((huber(c1) + huber(c2)) * aw).sum()

        def res_vec(xi):
            e1, e2 = residuals(xi, S_base)
            return torch.cat([e1 * sq1, e2 * sq2], 0)          # [2N,2]

        xi = torch.zeros((1, 7), dtype=f32, device=dev)
        lam = torch.tensor(1e-3, dtype=f32, device=dev)
        eye7 = torch.eye(7, dtype=f32, device=dev)
        for _ in range(SIM3_ITERS):
            # IRLS Huber weights from the current chi2 (no derivative).
            c1, c2 = chi2s(xi, S_base)
            w_h1 = torch.clamp_max(delta / torch.sqrt(c1.clamp_min(1e-12)), 1.0)
            w_h2 = torch.clamp_max(delta / torch.sqrt(c2.clamp_min(1e-12)), 1.0)
            w_all = torch.cat([w_h1 * aw, w_h2 * aw])            # [2N]
            r = res_vec(xi)
            J = _jacobians(lambda x: res_vec(x)[None], (xi,))[0][0]  # [2N,2,7]
            H = torch.einsum("n,nif,nig->fg", w_all, J, J)
            g = torch.einsum("n,nif,ni->f", w_all, J, r)
            A = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye7
            dx = -torch.linalg.solve(A, g)
            if fix_scale:
                dx = torch.where(torch.arange(7, device=dev) < 6, dx,
                                 torch.zeros_like(dx))     # xi[6] is log s
            improved = robust_cost(xi + dx) < robust_cost(xi)
            xi = torch.where(improved, xi + dx, xi)
            lam = torch.where(improved, lam * 0.5, lam * 4.0).clamp(1e-10, 1e8)
        return xi

    S_base = {"R": R0[None], "t": t0[None], "s": s0.reshape(1)}
    xi = run(valid, S_base)
    c1, c2 = chi2s(xi, S_base)
    inlier = valid & (c1 <= th2) & (c2 <= th2)
    # Stage 2 continues from the stage-1 optimum (upstream keeps the vertex
    # estimate and re-optimizes without the outlier edges,
    # Optimizer.cc:1189-1209); its inliers are the stage-1 inliers that
    # still pass.
    S_base2 = lie.sim3_mul(lie.sim3_exp(xi), S_base)
    xi2 = run(inlier, S_base2)
    c1, c2 = chi2s(xi2, S_base2)
    inlier = inlier & (c1 <= th2) & (c2 <= th2)
    S = lie.sim3_mul(lie.sim3_exp(xi2), S_base2)
    return inlier.sum(), S["s"][0], S["R"][0], S["t"][0], inlier
