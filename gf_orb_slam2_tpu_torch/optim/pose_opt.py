"""Motion-only pose optimization (per-frame bundle adjustment).

Replacement for Optimizer::PoseOptimization (reference: src/Optimizer.cc:248):
g2o LM over one SE3 vertex with mono/stereo unary edges, rounds × iterations
with chi2 outlier gating between rounds (chi2 5.991 mono / 7.815 stereo,
Huber kernel).

Batched analytic Jacobians over ALL observations at once, Levenberg-Marquardt
on the 6-dof left-multiplicative se(3) update with step acceptance, fixed
iteration counts. The JAX package runs the solve as one XLA program (a
`lax.scan`, gf_orb_slam2_tpu/optim/pose_opt.py:81); here CUDA tensors go to
one hand-written kernel launch for the whole solve (csrc/pose_lm.cu through
ops/pose_lm_cuda.py) and CPU tensors to `pose_optimization_ref`, the plain
PyTorch version, whose every decision inside the loop is a tensor
(`torch.where`). Neither reads a value back to the host, so a solve enqueues
without a single synchronization.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.ops.pose_lm_cuda import pose_lm

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = 2.4477  # sqrt(5.991)
HUBER_STEREO = 2.7955  # sqrt(7.815)


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor    # [N] bool — final chi2 gate
    n_inliers: torch.Tensor  # int64 scalar tensor
    chi2: torch.Tensor       # [N] final per-point chi2 (for diagnostics)


def _project(R, t, Xw, uv, u_right, is_stereo, fx, fy, cx, cy, bf):
    """Residuals [N,3] (3rd row = stereo, zeroed for mono), camera points and
    the clamped depth terms the Jacobian reuses."""
    pc = lie.transform(R, t, Xw)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zc = torch.where(z < 1e-6, 1e-6, z)
    iz = 1.0 / zc
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur_pred = u - bf * iz
    r = torch.stack(
        [u - uv[..., 0], v - uv[..., 1],
         torch.where(is_stereo, ur_pred - u_right, 0.0)], -1)
    return r, pc, iz


def _residuals_jacobians(R, t, Xw, uv, u_right, fx, fy, cx, cy, bf):
    """Residuals [N,3] and J [N,3,6].

    se(3) update convention: T ← exp([rho, phi]) ∘ T (left multiplicative),
    so ∂pc/∂xi = [ I | -hat(pc) ].
    """
    is_stereo = u_right >= 0
    r, pc, iz = _project(R, t, Xw, uv, u_right, is_stereo, fx, fy, cx, cy, bf)
    x, y = pc[..., 0], pc[..., 1]
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    st = is_stereo.to(x.dtype)
    # ∂(u,v,ur)/∂pc  [N,3,3]
    d_pc = torch.stack(
        [
            torch.stack([fx * iz, zero, -fx * x * iz2], -1),
            torch.stack([zero, fy * iz, -fy * y * iz2], -1),
            torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1) * st[..., None],
        ],
        -2,
    )
    # ∂pc/∂xi = [I | -hat(pc)]  [N,3,6]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    d_xi = torch.cat([eye, -lie.hat(pc)], -1)
    J = d_pc @ d_xi  # [N,3,6]
    return r, J, pc[..., 2]


def _chi2(r, inv_sigma2, is_stereo):
    e2 = torch.sum(r[..., :2] ** 2, -1) + torch.where(is_stereo, r[..., 2] ** 2, 0.0)
    return e2 * inv_sigma2


def pose_optimization(
    R0, t0, Xw, uv, u_right, inv_sigma2, valid,
    fx, fy, cx, cy, bf,
    rounds: int = 4, iters: int = 10, damping: float = 1e-5,
):
    """Optimize Tcw from 3D-2D(+disparity) correspondences (arguments and
    result: `pose_optimization_ref`). CUDA tensors launch the pose LM kernel
    once (float32 only: another dtype raises); CPU tensors run the plain
    version."""
    if Xw.is_cuda:
        args = [x.contiguous() for x in (R0, t0, Xw, uv, u_right, inv_sigma2, valid)]
        return PoseOptResult(*pose_lm(*args, fx, fy, cx, cy, bf, rounds, iters, damping))
    return pose_optimization_ref(R0, t0, Xw, uv, u_right, inv_sigma2, valid,
                                 fx, fy, cx, cy, bf, rounds, iters, damping)


def pose_optimization_ref(
    R0, t0, Xw, uv, u_right, inv_sigma2, valid,
    fx, fy, cx, cy, bf,
    rounds: int = 4, iters: int = 10, damping: float = 1e-5,
):
    """Plain PyTorch version of the pose LM (any device). Optimize Tcw from 3D-2D(+disparity) correspondences.

    Xw: [N,3] world points; uv: [N,2] observed pixels; u_right: [N] observed
    right-cam u (<0 ⇒ monocular observation); inv_sigma2: [N] per-octave
    information; valid: [N] initial correspondence mask.
    Mirrors the reference's round structure: each round re-gates outliers by
    chi2 and Huber-weights the survivors. A frame with no valid point (or a
    singular system) leaves the pose where it started: the damped system
    H + λ·(damping + diag H)·I is never exactly singular, and a non-finite
    step is rejected.
    """
    dev, dt = Xw.device, Xw.dtype
    is_stereo = u_right >= 0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(dt)
    delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO).to(dt)
    d2 = delta * delta
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def rho_of(c2):
        e = torch.sqrt(torch.clamp(c2, min=1e-12))
        return e, torch.where(e <= delta, c2, 2.0 * delta * e - d2)

    def robust_cost(R, t, inlier):
        """Σ huber_rho(chi2) over active observations."""
        r, pc, _ = _project(R, t, Xw, uv, u_right, is_stereo, fx, fy, cx, cy, bf)
        c2 = _chi2(r, inv_sigma2, is_stereo)
        _, rho = rho_of(c2)
        return torch.sum(torch.where(inlier & (pc[..., 2] > 1e-4), rho, 0.0))

    R, t = R0, t0
    inlier = valid
    cost = robust_cost(R, t, inlier)
    lam = torch.full((), 1e-3, dtype=dt, device=dev)  # a fill: no host-to-device copy
    lam0 = lam.clone()
    for step in range(rounds * iters):
        # Exactly TWO residual passes per step: the Jacobian pass at the
        # current pose doubles as the round-boundary re-gate, and the
        # candidate pass prices the LM step.
        r, J, depth = _residuals_jacobians(R, t, Xw, uv, u_right, fx, fy, cx, cy, bf)
        c2 = _chi2(r, inv_sigma2, is_stereo)
        e, rho = rho_of(c2)
        if step % iters == 0 and step > 0:
            # round-boundary chi2 re-gate (reference: between-round outlier
            # gate), reusing this step's residuals; the step index is host
            # control flow, the gate itself stays on the device
            inlier = valid & (c2 <= chi2_th) & (depth > 1e-4)
            cost = torch.sum(torch.where(inlier, rho, 0.0))
            lam = lam0
        active = inlier & (depth > 1e-4)
        w_huber = torch.where(e <= delta, 1.0, delta / e)
        w = inv_sigma2 * w_huber * active.to(dt)
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        b = torch.einsum("nri,nr->i", Jw, r)
        D = eye6 * (damping + torch.diagonal(H))
        # solve_ex never raises on a singular system (it reports through
        # `info`); whatever it returns then is caught by the finite guard
        xi = -torch.linalg.solve_ex(H + lam * D, b)[0]
        dR, dtr = lie.se3_exp(xi)
        R_new, t_new = lie.se3_compose(dR, dtr, R, t)
        cost_new = robust_cost(R_new, t_new, inlier)
        # explicit finiteness guard: a NaN candidate pose NaN-masks every
        # depth gate, making robust_cost 0.0 — which the plain comparison
        # would "accept"
        accept = (cost_new < cost) & torch.isfinite(xi).all() & torch.isfinite(cost_new)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e6)

    r, pc, _ = _project(R, t, Xw, uv, u_right, is_stereo, fx, fy, cx, cy, bf)
    c2 = _chi2(r, inv_sigma2, is_stereo)
    inliers = valid & (c2 <= chi2_th) & (pc[..., 2] > 1e-4)
    return PoseOptResult(R, t, inliers, inliers.sum(), c2)
