"""Local bundle adjustment: Schur-complement Levenberg-Marquardt, batched.

Replacement for Optimizer::LocalBundleAdjustment (reference:
src/Optimizer.cc:618/1248-1545 — g2o BlockSolver_6_3 LM over ≤60 covisible
KFs + their points, 5+10 iterations with chi2 gating). At local-BA scale the
reduced camera system is a small dense matrix:

  Hll (3x3 per point) → batched adjugate inverse →
  S = Hpp - Σ_p T_p Hll_p⁻¹ T_pᵀ  (dense [6F,6F]) →
  Cholesky solve → back-substitution for points.

Observations are a fixed-capacity [P, O] table (point-major); poses enter
through a one-hot assignment built by comparison with the slot index, so an
observation with pose slot -1 (fixed, padded or over the cap) contributes a
zero row and never wraps to the last slot. Every decision of the LM loop is
a tensor (`torch.where`), so a solve enqueues without a host synchronization.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.utils.linalg3 import inv3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = 2.4477
HUBER_STEREO = 2.7955


class LocalBAProblem(NamedTuple):
    """Fixed-capacity local BA problem (SoA, masked).

    K keyframes (optimized unless kf_fixed), P points, O obs slots/point.
    """

    kf_R: torch.Tensor        # [K,3,3]
    kf_t: torch.Tensor        # [K,3]
    kf_fixed: torch.Tensor    # [K] bool — pose held constant
    kf_valid: torch.Tensor    # [K] bool
    pt_pos: torch.Tensor      # [P,3]
    pt_valid: torch.Tensor    # [P] bool
    obs_kf: torch.Tensor      # [P,O] int64 index into K (-1 empty)
    obs_uv: torch.Tensor      # [P,O,2]
    obs_ur: torch.Tensor      # [P,O] (<0 mono)
    obs_inv_sigma2: torch.Tensor  # [P,O]
    obs_valid: torch.Tensor   # [P,O] bool


class LocalBAResult(NamedTuple):
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    pt_pos: torch.Tensor
    obs_inlier: torch.Tensor  # [P,O] bool — post-gating
    final_cost: torch.Tensor


def one_hot(idx, n: int, dtype):
    """[..] int → [..,n]; an index outside [0, n) (in particular -1) gives a
    zero row, as jax.nn.one_hot does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _residuals(prob: LocalBAProblem, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf):
    """Per-obs residual [P,O,3] + Jacobians J_pose [P,O,3,6], J_pt [P,O,3,3]
    and depth [P,O]."""
    k = torch.clamp(prob.obs_kf, min=0)
    R = kf_R[k]          # [P,O,3,3]
    t = kf_t[k]          # [P,O,3]
    pc = torch.einsum("poij,pj->poi", R, pt_pos) + t
    x, y = pc[..., 0], pc[..., 1]
    z = torch.where(pc[..., 2] < 1e-6, 1e-6, pc[..., 2])
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    is_stereo = prob.obs_ur >= 0
    ur_pred = u - bf * iz
    r = torch.stack(
        [u - prob.obs_uv[..., 0], v - prob.obs_uv[..., 1],
         torch.where(is_stereo, ur_pred - prob.obs_ur, 0.0)], -1)
    zero = torch.zeros_like(x)
    d_pc = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], -1),
        torch.stack([zero, fy * iz, -fy * y * iz2], -1),
        torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1)
        * is_stereo[..., None].to(x.dtype),
    ], -2)  # [P,O,3,3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    d_xi = torch.cat([eye, -lie.hat(pc)], -1)  # [P,O,3,6]
    J_pose = d_pc @ d_xi
    J_pt = d_pc @ R  # ∂pc/∂X = R
    return r, J_pose, J_pt, pc[..., 2]


def _chi2(r, inv_sigma2, is_stereo):
    e2 = torch.sum(r[..., :2] ** 2, -1) + torch.where(is_stereo, r[..., 2] ** 2, 0.0)
    return e2 * inv_sigma2


def _diag_add(S, blocks):
    """S [K,K,a,b] with `blocks` [K,a,b] added on its block diagonal."""
    K = S.shape[0]
    ar = torch.arange(K, device=S.device)
    S = S.clone()
    S[ar, ar] += blocks
    return S


def pose_schur_blocks(prob: LocalBAProblem, fx, fy, cx, cy, bf, eps=1e-2):
    """Pose-block Schur complement S = Hpp - T Hll⁻¹ Tᵀ as [K,K,6,6], at the
    current linearization point with plain (non-robust) weights: the input
    of good-graph selection (reference: the SLAM++ 'SC' matrix,
    NonlinearSolver_GoodGraph.h:978-1047)."""
    K = prob.kf_R.shape[0]
    r, J_pose, J_pt, depth = _residuals(
        prob, prob.kf_R, prob.kf_t, prob.pt_pos, fx, fy, cx, cy, bf)
    valid = prob.obs_valid & (prob.obs_kf >= 0) & prob.pt_valid[:, None] & (depth > 1e-4)
    w = prob.obs_inv_sigma2 * valid.to(r.dtype)
    onehot = one_hot(prob.obs_kf, K, prob.kf_R.dtype)
    wJp = w[..., None, None] * J_pose
    M = torch.einsum("poab,poac->pobc", wJp, J_pose)
    Hpp = torch.einsum("pok,pobc->kbc", onehot, M)
    wJl = w[..., None, None] * J_pt
    Hll = torch.einsum("poab,poac->pbc", wJl, J_pt)
    C = torch.einsum("poab,poac->pobc", wJp, J_pt)
    T1 = torch.einsum("pok,pobc->pkbc", onehot, C)
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Vinv = inv3(Hll + eps * eye3) * prob.pt_valid[:, None, None]
    T1V = torch.einsum("pkab,pbc->pkac", T1, Vinv)
    S_cross = torch.einsum("pkac,pmdc->kmad", T1V, T1)  # [K,K,6,6]
    return _diag_add(-S_cross, Hpp)


def local_bundle_adjustment(
    prob: LocalBAProblem, fx, fy, cx, cy, bf,
    iters_first: int = 5, iters_second: int = 10, damping: float = 1e-4,
    free_cap: int = None,
):
    """The reference's 5-iter → gate → 10-iter LM schedule
    (Optimizer.cc:1390-1470) with step acceptance.

    `free_cap`: if set and below K, the pose system is COMPACTED to the first
    `free_cap` free poses (stable order) before the solve — fixed poses
    contribute residuals but no rows, so the reduced camera system is
    [6F,6F]; free poses beyond the cap are held fixed.

    A step is taken only if its cost is lower AND it is finite: the Cholesky
    factorization of S reports failure (`info != 0`) on an S driven
    indefinite by f32 roundoff, and a non-finite pose would NaN-mask every
    depth test so the robust cost reads 0 — both are rejected.
    """
    K = prob.kf_R.shape[0]
    dev, dt = prob.kf_R.device, prob.kf_R.dtype
    is_stereo = prob.obs_ur >= 0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    opt_mask = (~prob.kf_fixed) & prob.kf_valid  # poses that move
    obs_kf_c = torch.clamp(prob.obs_kf, min=0)
    if free_cap is not None and free_cap < K:
        F = free_cap
        # stable compaction: free poses first, then a [K]→[F] slot lut
        order = torch.sort((~opt_mask).to(torch.int8), stable=True).indices
        free_idx = order[:F]                       # [F] global slots
        f_valid = opt_mask[free_idx]
        lut = torch.full((K,), -1, dtype=torch.int64, device=dev)
        lut[free_idx] = torch.where(f_valid, torch.arange(F, device=dev), -1)
        obs_slot = torch.where(prob.obs_kf >= 0, lut[obs_kf_c], -1)  # [P,O]
    else:
        F = K
        free_idx = torch.arange(K, device=dev)
        f_valid = opt_mask
        obs_slot = torch.where(opt_mask[obs_kf_c] & (prob.obs_kf >= 0), prob.obs_kf, -1)
    onehot = one_hot(obs_slot, F, dt)  # [P,O,F]
    pose_on = (obs_slot >= 0)[..., None, None].to(dt)
    act6 = f_valid.repeat_interleave(6)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    base_valid = prob.obs_valid & (prob.obs_kf >= 0) & prob.pt_valid[:, None]
    pt_on = prob.pt_valid[:, None].to(dt)

    def rho_of(c2):
        e = torch.sqrt(torch.clamp(c2, min=1e-12))
        return e, torch.where(e <= delta, c2, 2.0 * delta * e - delta * delta)

    def robust_cost(kf_R, kf_t, pt_pos, active):
        r, _, _, depth = _residuals(prob, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf)
        _, rho = rho_of(_chi2(r, prob.obs_inv_sigma2, is_stereo))
        return torch.sum(torch.where(active & (depth > 1e-4), rho, 0.0))

    def reduced_camera_matrix(Hpp, lam):
        D = eye6[None] * (damping + lam + torch.einsum("kii->k", Hpp)[:, None, None] / 6.0 * lam)
        blocks = torch.zeros((F, F, 6, 6), dtype=dt, device=dev)
        blocks = _diag_add(blocks, Hpp + D)
        return blocks.permute(0, 2, 1, 3).reshape(F * 6, F * 6)

    kf_R, kf_t, pt_pos = prob.kf_R, prob.kf_t, prob.pt_pos
    active = base_valid
    cost = robust_cost(kf_R, kf_t, pt_pos, active)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)  # a fill: no host-to-device copy
    for step in range(iters_first + iters_second):
        r, J_pose, J_pt, depth = _residuals(prob, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf)
        c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
        e, rho = rho_of(c2)
        if step == iters_first:
            # mid-schedule outlier gate (reference 5-iter → gate → 10-iter),
            # applied at the start of this step from its own residuals
            active = base_valid & (c2 <= chi2_th) & (depth > 1e-4)
            cost = torch.sum(torch.where(active & (depth > 1e-4), rho, 0.0))
            lam = torch.full_like(lam, 1e-4)
        w_huber = torch.where(e <= delta, 1.0, delta / e)
        w = prob.obs_inv_sigma2 * w_huber * (active & (depth > 1e-4)).to(dt)
        Jp = J_pose * pose_on  # zero fixed/invalid/over-cap pose Jacobians

        # blocks, staged so no [P,O,F,6,6] intermediate exists
        wJp = w[..., None, None] * Jp                                          # [P,O,3,6]
        Hpp = torch.einsum("pok,pobc->kbc", onehot,
                           torch.einsum("poab,poac->pobc", wJp, Jp))           # [F,6,6]
        bp = torch.einsum("pok,pob->kb", onehot,
                          torch.einsum("poab,poa->pob", wJp, r))               # [F,6]
        wJl = w[..., None, None] * J_pt                                        # [P,O,3,3]
        Hll = torch.einsum("poab,poac->pbc", wJl, J_pt)                        # [P,3,3]
        bl = torch.einsum("poab,poa->pb", wJl, r)                              # [P,3]
        T1 = torch.einsum("pok,pobc->pkbc", onehot,
                          torch.einsum("poab,poac->pobc", wJp, J_pt))          # [P,F,6,3]
        lamHll = Hll + (damping + lam) * eye3 * (
            1.0 + torch.einsum("pii->p", Hll)[:, None, None] / 3.0)
        Vinv = inv3(lamHll) * prob.pt_valid[:, None, None]                    # [P,3,3]
        T1V = torch.einsum("pkab,pbc->pkac", T1, Vinv)                         # [P,F,6,3]
        S_cross = torch.einsum("pkac,pmdc->kmad", T1V, T1)                     # [F,F,6,6]
        S = reduced_camera_matrix(Hpp, lam) - S_cross.permute(0, 2, 1, 3).reshape(F * 6, F * 6)
        bs = bp.reshape(-1) - torch.einsum("pkac,pc->ka", T1V, bl).reshape(-1)
        # inactive slots: identity rows
        S = torch.where(act6[:, None] & act6[None, :], S, 0.0)
        S = S + torch.diag(torch.where(act6, 0.0, 1.0).to(dt))
        bs = torch.where(act6, bs, 0.0)
        L, info = torch.linalg.cholesky_ex(S)
        y = torch.linalg.solve_triangular(L, bs[:, None], upper=False)
        xi_f = -torch.linalg.solve_triangular(L.mT, y, upper=True).reshape(F, 6)
        xi_f = xi_f * f_valid[:, None]
        # back-substitute points: Hll dx = -(bl + T1ᵀ xi)
        rhs_l = bl + torch.einsum("pkab,ka->pb", T1, xi_f)
        dx = -torch.einsum("pbc,pc->pb", Vinv, rhs_l)
        # scatter the compacted update back to the full pose set
        xi_p = torch.zeros((K, 6), dtype=dt, device=dev).index_copy(0, free_idx, xi_f)

        dR, dtr = lie.se3_exp(xi_p)
        kf_R_new, kf_t_new = lie.se3_compose(dR, dtr, kf_R, kf_t)
        pt_new = pt_pos + dx * pt_on
        cost_new = robust_cost(kf_R_new, kf_t_new, pt_new, active)
        finite = ((info == 0) & torch.isfinite(xi_f).all() & torch.isfinite(dx).all()
                  & torch.isfinite(cost_new))
        accept = (cost_new < cost) & finite
        kf_R = torch.where(accept, kf_R_new, kf_R)
        kf_t = torch.where(accept, kf_t_new, kf_t)
        pt_pos = torch.where(accept, pt_new, pt_pos)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e6)
    r, _, _, depth = _residuals(prob, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf)
    c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
    inlier = base_valid & (c2 <= chi2_th) & (depth > 1e-4)
    return LocalBAResult(kf_R, kf_t, pt_pos, inlier, cost)
