"""Essential-graph Sim3 pose-graph optimization.

Replacement for Optimizer::OptimizeEssentialGraph (reference:
src/Optimizer.cc:2338 — g2o BlockSolver_7_3 LM over Sim3 vertices with
edges from the spanning tree, strong-covisibility (≥100) links and loop
edges; scale fixed for stereo/RGB-D):

- vertices: [K] Sim3 as (s, R, t); update S ← exp(δ)∘S, δ∈ℝ⁷;
- edges: [E] index pairs + measured relative Sim3 (S_ij = S_i·S_j⁻¹ when the
  graph is built; loop edges carry the Sim3-solver estimate);
- residual r_e = log(S_meas ∘ S_j ∘ S_i⁻¹) ∈ ℝ⁷, Jacobians in forward mode
  over the 14 dof of each edge, all edges at once (utils/autodiff.py);
- one dense [7K,7K] normal-equation solve per iteration with LM damping,
  step acceptance and a finiteness guard.

K and E are the problem's own (no shape buckets: nothing is compiled); an
edge of weight 0 changes nothing. Every decision is a tensor, so the solve
enqueues without waiting for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.utils.autodiff import row_jacobian


class PoseGraphProblem(NamedTuple):
    s: torch.Tensor         # [K] scales
    R: torch.Tensor         # [K,3,3]
    t: torch.Tensor         # [K,3]
    fixed: torch.Tensor     # [K] bool
    valid: torch.Tensor     # [K] bool
    e_i: torch.Tensor       # [E] int64
    e_j: torch.Tensor       # [E] int64
    e_s: torch.Tensor       # [E] measured relative scale
    e_R: torch.Tensor       # [E,3,3]
    e_t: torch.Tensor       # [E,3]
    e_w: torch.Tensor       # [E] weight (0 = no contribution)
    fix_scale: bool = True


def _edge_residual(si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """log( S_meas ∘ S_j ∘ S_i⁻¹ )."""
    s_inv, R_inv, t_inv = lie.sim3_inv(si, Ri, ti)
    s1, R1, t1 = lie.sim3_compose(sj, Rj, tj, s_inv, R_inv, t_inv)
    s2, R2, t2 = lie.sim3_compose(sm, Rm, tm, s1, R1, t1)
    return lie.sim3_log(s2, R2, t2)


def _edge_residual_delta(delta, si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """The residual after perturbing vertex i by δ[..., :7] and j by
    δ[..., 7:]."""
    dsi, dRi, dti = lie.sim3_exp(delta[..., :7])
    dsj, dRj, dtj = lie.sim3_exp(delta[..., 7:])
    si2, Ri2, ti2 = lie.sim3_compose(dsi, dRi, dti, si, Ri, ti)
    sj2, Rj2, tj2 = lie.sim3_compose(dsj, dRj, dtj, sj, Rj, tj)
    return _edge_residual(si2, Ri2, ti2, sj2, Rj2, tj2, sm, Rm, tm)


def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 15, damping: float = 1e-6):
    """LM over the essential graph; fixed and invalid vertices are pinned.
    Returns (s, R, t, cost)."""
    K = prob.s.shape[0]
    n = 7 * K
    dev, dt = prob.s.device, prob.s.dtype
    e_i, e_j, w = prob.e_i.long(), prob.e_j.long(), prob.e_w
    E = e_i.shape[0]
    free = prob.valid & ~prob.fixed
    dof_mask = free.repeat_interleave(7).to(dt)
    if prob.fix_scale:
        dof_mask = dof_mask * (torch.arange(n, device=dev) % 7 != 6).to(dt)
    meas = (prob.e_s, prob.e_R, prob.e_t)

    def edge_args(s, R, t):
        return (s[e_i], R[e_i], t[e_i], s[e_j], R[e_j], t[e_j]) + meas

    def total_cost(s, R, t):
        r = _edge_residual(*edge_args(s, R, t))
        return torch.sum(w * torch.sum(r * r, -1))

    # dense [K,7,K,7] assembly: 7x7 blocks scattered at (i,i), (j,j), (i,j), (j,i)
    blk_ii, blk_jj = e_i * K + e_i, e_j * K + e_j
    blk_ij, blk_ji = e_i * K + e_j, e_j * K + e_i
    blk = torch.cat([blk_ii, blk_jj, blk_ij, blk_ji])
    s, R, t = prob.s, prob.R, prob.t
    cost = total_cost(s, R, t)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    zeros = torch.zeros((E, 14), dtype=dt, device=dev)
    for _ in range(iters):
        args = edge_args(s, R, t)
        r = _edge_residual(*args)                              # [E,7]
        J = row_jacobian(_edge_residual_delta, zeros, *args)   # [E,7,14]
        Ji, Jj = J[..., :7], J[..., 7:]
        Hii = torch.einsum("e,era,erb->eab", w, Ji, Ji)
        Hjj = torch.einsum("e,era,erb->eab", w, Jj, Jj)
        Hij = torch.einsum("e,era,erb->eab", w, Ji, Jj)
        blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])
        H = torch.zeros((K * K, 7, 7), dtype=dt, device=dev).index_add_(0, blk, blocks)
        H = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(n, n)
        b = torch.zeros((K, 7), dtype=dt, device=dev)
        b = b.index_add_(0, e_i, torch.einsum("e,era,er->ea", w, Ji, r))
        b = b.index_add_(0, e_j, torch.einsum("e,era,er->ea", w, Jj, r))
        Hm = H * dof_mask[:, None] * dof_mask[None, :]
        Hm = Hm + torch.diag(torch.where(dof_mask > 0, damping + lam * (1.0 + torch.diagonal(H)), 1.0))
        bm = b.reshape(n) * dof_mask
        sol, info = torch.linalg.solve_ex(Hm, bm)
        delta = -sol.reshape(K, 7) * dof_mask.reshape(K, 7)
        ds, dR, dtr = lie.sim3_exp(delta)
        s_new, R_new, t_new = lie.sim3_compose(ds, dR, dtr, s, R, t)
        cost_new = total_cost(s_new, R_new, t_new)
        # a singular Hm gives inf/NaN (or a failed factorization): such a step
        # is never taken
        finite = (info == 0) & torch.isfinite(delta).all() & torch.isfinite(cost_new)
        accept = (cost_new < cost) & finite
        s = torch.where(accept, s_new, s)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
    return s, R, t, cost
