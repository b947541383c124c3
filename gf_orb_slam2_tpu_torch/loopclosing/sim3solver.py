"""Sim3 RANSAC between two keyframes' matched map points, and its GN polish.

Replacement for Sim3Solver (reference: src/Sim3Solver.cc — sequential
RANSAC, 3-point Horn per hypothesis (ComputeSim3 :~229), two-way
reprojection inlier check (CheckInliers :335), fixed scale for stereo/RGB-D)
and Optimizer::OptimizeSim3. All hypotheses run as one batched program:
[S,3] samples → batched Horn → [S,N] two-way inlier counts → argmax → a
refit on the winner's inliers. Every decision is a tensor (`torch.where`),
so a solve enqueues without waiting for the device.

The draws are an input: `solve_sim3` takes explicit `draws` [n_hyp,3]
(indices into the valid points, in order) or a `torch.Generator` to draw
them from — the JAX package draws with `jax.random`, so a caller that wants
its hypotheses passes its draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.utils.autodiff import row_jacobian


class Sim3Result(NamedTuple):
    ok: torch.Tensor          # [] bool
    s: torch.Tensor           # [] scale 1→2
    R: torch.Tensor           # [3,3]
    t: torch.Tensor           # [3]
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # [] int64


def _project(p, fx, fy, cx, cy):
    z = torch.clamp(p[..., 2], min=1e-6)
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)


def optimize_sim3(
    s0, R0, t0, pc1, pc2, inliers, fx, fy, cx, cy,
    fix_scale: bool = False, iters: int = 8, th2_px: float = 9.21,
):
    """GN polish of a relative Sim3 with two-way reprojection residuals
    (replaces Optimizer::OptimizeSim3, reference Optimizer.h:100): a 7-dof
    left-multiplied update with forward-mode Jacobians, fixed iterations,
    chi2 re-gate at the end. Returns (s, R, t, inliers).

    The residual of point n is evaluated under its own copy of the update
    (all copies equal), so its Jacobian is a row Jacobian
    (utils/autodiff.row_jacobian)."""

    def residuals(xi, s, R, t):
        """xi [N,7] → [N,4] (r1 in image 1, r2 in image 2)."""
        ds, dR, dt = lie.sim3_exp(xi)
        s_, R_, t_ = lie.sim3_compose(ds, dR, dt, s, R, t)
        p1in2 = lie.sim3_apply(s_, R_, t_, pc1)
        si, Ri, ti = lie.sim3_inv(s_, R_, t_)
        p2in1 = lie.sim3_apply(si, Ri, ti, pc2)
        r2 = _project(p1in2, fx, fy, cx, cy) - _project(pc2, fx, fy, cx, cy)
        r1 = _project(p2in1, fx, fy, cx, cy) - _project(pc1, fx, fy, cx, cy)
        return torch.cat([r1, r2], -1)

    dev, dt = pc1.device, pc1.dtype
    w0 = inliers.to(dt)
    s, R, t = s0, R0, t0
    mask7 = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        mask7[6] = 0.0
    zero = torch.zeros((pc1.shape[0], 7), dtype=dt, device=dev)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    for _ in range(iters):
        r = residuals(zero, s, R, t)                       # [N,4]
        J = row_jacobian(residuals, zero, s, R, t)         # [N,4,7]
        H = torch.einsum("n,nri,nrj->ij", w0, J, J) + 1e-4 * eye7
        b = torch.einsum("n,nri,nr->i", w0, J, r)
        xi = -torch.linalg.solve_ex(H, b)[0] * mask7
        ds, dR, dt_ = lie.sim3_exp(xi)
        s, R, t = lie.sim3_compose(ds, dR, dt_, s, R, t)
    r = residuals(zero, s, R, t)
    e2 = torch.sum(r[..., :2] ** 2, -1) + torch.sum(r[..., 2:] ** 2, -1)
    return s, R, t, inliers & (e2 < 2 * th2_px)


def draw_hypotheses(n_valid: int, generator: torch.Generator, n_hyp: int = 128):
    """[n_hyp,3] sample indices in [0, max(n_valid, 3)) from `generator`, on
    the generator's device."""
    return torch.randint(0, max(int(n_valid), 3), (n_hyp, 3), generator=generator,
                         device=generator.device)


def _weighted_horn(a, b, w, fix_scale):
    """Horn alignment b ≈ s·R·a + t over the points weighted by w (the
    winner's inliers); full-f32 contractions (utils/precision.py)."""
    n = torch.clamp(torch.sum(w), min=1.0)
    mu_a = torch.sum(a * w[:, None], 0) / n
    mu_b = torch.sum(b * w[:, None], 0) / n
    ac = (a - mu_a) * w[:, None]
    H = ac.T @ (b - mu_b)
    U, S, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    R = Vt.T @ (D[:, None] * U.T)
    var = torch.sum(ac * ac) / torch.clamp(n, min=1e-9)
    if fix_scale:
        scale = torch.ones_like(var)
    else:
        scale = torch.sum(S * D) / torch.clamp(var * n, min=1e-9)
    t = mu_b - scale * (R @ mu_a)
    return scale, R, t


def solve_sim3(
    pc1, pc2, valid, fx, fy, cx, cy, generator=None, draws=None,
    fix_scale: bool = False, n_hyp: int = 128,
    th2_px: float = 9.21, min_inliers: int = 20,
):
    """pc1/pc2 [N,3]: corresponding points in each camera frame; valid [N].
    Convention: pc2 ≈ s·R·pc1 + t (Sim3 T21).

    `draws` [n_hyp,3]: indices into the valid points in their order (the
    stable order of `argsort(~valid)`); without them they are drawn from
    `generator`, which needs the valid count on the host. th2_px: the
    squared-pixel gate (reference 9.21·σ²). Returns Sim3Result."""
    dev, dt = pc1.device, pc1.dtype
    # valid points first, in their order: a STABLE sort, as the JAX argsort
    idx_valid = torch.sort((~valid).to(torch.int8), stable=True).indices
    if draws is None:
        draws = draw_hypotheses(int(valid.sum()), generator, n_hyp)
    samples = idx_valid[draws.to(dev)]                     # [S,3]
    ss, Rs, ts = lie.horn_sim3(pc1[samples], pc2[samples], fix_scale=fix_scale)

    uv1_obs = _project(pc1, fx, fy, cx, cy)
    uv2_obs = _project(pc2, fx, fy, cx, cy)

    def count(s, R, t):
        """[...] hypotheses → [..., N] two-way inlier masks."""
        p1in2 = lie.sim3_apply(s[..., None], R[..., None, :, :], t[..., None, :], pc1)
        si, Ri, ti = lie.sim3_inv(s, R, t)
        p2in1 = lie.sim3_apply(si[..., None], Ri[..., None, :, :], ti[..., None, :], pc2)
        e2 = torch.sum((_project(p1in2, fx, fy, cx, cy) - uv2_obs) ** 2, -1)
        e1 = torch.sum((_project(p2in1, fx, fy, cx, cy) - uv1_obs) ** 2, -1)
        return (valid & (e1 < th2_px) & (e2 < th2_px)
                & (p1in2[..., 2] > 0) & (p2in1[..., 2] > 0))

    inls = count(ss, Rs, ts)                               # [S,N]
    votes = torch.sum(inls, -1)
    best = torch.argmax(votes)  # first maximum, as jnp.argmax
    s_f, R_f, t_f = _weighted_horn(pc1, pc2, inls[best].to(dt), fix_scale)
    inl_f = count(s_f, R_f, t_f)
    n_f = torch.sum(inl_f)
    use_refit = n_f >= votes[best]
    n_out = torch.maximum(n_f, votes[best])
    return Sim3Result(
        ok=n_out >= min_inliers,
        s=torch.where(use_refit, s_f, ss[best]),
        R=torch.where(use_refit, R_f, Rs[best]),
        t=torch.where(use_refit, t_f, ts[best]),
        inliers=torch.where(use_refit, inl_f, inls[best]),
        n_inliers=n_out)
