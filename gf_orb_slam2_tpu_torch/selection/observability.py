"""Observability: per-landmark measurement Jacobians + information matrices.

Replacement for the Observability class (reference: src/Observability.cc,
include/Observability.h): the good-feature engine's math substrate. The
reference builds per-point Jacobians H13 (∂h/∂p), H47 (∂h/∂q) with
hand-derived quaternion algebra (compute_H_subblock_complete
Observability.h:376, disparity row :597) and parallelizes the batch across
std::threads with a 2ms time cap (runMatrixBuilding Observability.cc:668).
Here the entire batch is a handful of tensor ops giving [P,3,7] measurement
Jacobians and [P,7,7] information matrices.

State convention (reference: 13-dim Xv = [p(3), q(4), v(3), ω(3)],
Observability.h:266): p = camera position in world, q = Hamilton [w,x,y,z]
camera→world rotation. The info-matrix block used for good-feature selection
is the pose part [p, q] → 7x7 (reference: Tracking.cc:271-274 size choice);
the hybrid mode (`good_feature.info_mat_size=13`) uses the full 13x13 state
with a kinematic prior on the velocity block.

`pose_info_for_selection` gives the local step's selection its inputs: CUDA
tensors launch one hand-written kernel (csrc/obs_info.cu through
ops/obs_info_cuda.py), CPU tensors run `pose_info_for_selection_ref`, the
plain composition of the functions below.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.ops.obs_info_cuda import obs_info
from gf_orb_slam2_tpu_torch.tracking.kinematics import KineState, predict, process_jacobian


def measurement_jacobians(q, p, pts, fx, fy, bf, stereo_mask):
    """Batched H = [∂h/∂p | ∂h/∂q] for landmarks pts [P,3].

    Returns (H [P,3,7], pc [P,3]) where rows are (u, v, u_right) and the
    u_right row is zeroed for non-stereo landmarks. Mirrors
    compute_H_subblock_complete + compute_H_disparity_col
    (reference: Observability.h:376/:597) for the rectified pinhole model.
    """
    R_wc = lie.quat_to_rot(q)  # [3,3]
    R_cw = R_wc.T

    d = pts - p  # [P,3]
    pc = d @ R_wc  # rows: R_cw · d
    x, y_, z = pc[..., 0], pc[..., 1], torch.clamp(pc[..., 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    # ∂(u,v,ur)/∂pc
    A = torch.stack(
        [
            torch.stack([fx * iz, zero, -fx * x * iz2], -1),
            torch.stack([zero, fy * iz, -fy * y_ * iz2], -1),
            torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1)
            * stereo_mask[:, None].to(x.dtype),
        ],
        -2,
    )  # [P,3,3]
    # ∂pc/∂p = -R_cw (same for all points)
    dpc_dp = -R_cw  # [3,3]
    # ∂pc/∂q analytic (pc = R(q)ᵀ d): with q=[w,v],
    #   pc = (w²-vᵀv)d + 2(vᵀd)v - 2w(v×d)
    #   ∂pc/∂w = 2w·d - 2(v×d)
    #   ∂pc/∂v = 2·v dᵀ + 2(vᵀd)I - 2·d vᵀ + 2w·[d]ₓ
    # projected onto the unit-quaternion tangent (I - qqᵀ) so it matches the
    # derivative through normalization.
    w_, v_ = q[0], q[1:]
    vxd = torch.linalg.cross(v_.expand(d.shape), d)
    dpc_dw = 2.0 * w_ * d - 2.0 * vxd  # [P,3]
    eye3 = torch.eye(3, dtype=d.dtype, device=d.device)
    vtd = d @ v_
    dpc_dv = (
        2.0 * v_[None, :, None] * d[:, None, :]
        + 2.0 * vtd[:, None, None] * eye3[None]
        - 2.0 * d[:, :, None] * v_[None, None, :]
        + 2.0 * w_ * lie.hat(d)
    )  # [P,3,3]
    dpc_dq = torch.cat([dpc_dw[:, :, None], dpc_dv], -1)  # [P,3,4]
    proj = torch.eye(4, dtype=d.dtype, device=d.device) - torch.outer(q, q)
    dpc_dq = dpc_dq @ proj
    H_p = A @ dpc_dp   # [P,3,3]
    H_q = A @ dpc_dq   # [P,3,4]
    H = torch.cat([H_p, H_q], -1)      # [P,3,7]
    return H, pc


def info_matrices(q, p, pts, fx, fy, bf, stereo_mask, inv_sigma2, valid):
    """Per-landmark 7x7 observability/information matrices
    (reference: MapPoint::ObsMat cache, batchInfoMat_* Observability.cc:391).

    Returns ObsMat [P,7,7]; invalid landmarks get zeros.
    """
    H, pc = measurement_jacobians(q, p, pts, fx, fy, bf, stereo_mask)
    w = (valid & (pc[..., 2] > 1e-3)).to(H.dtype) * inv_sigma2
    return (H * w[:, None, None]).transpose(1, 2) @ H


def pose_info_from_frame(q, p, pts, fx, fy, bf, stereo_mask, inv_sigma2, valid):
    """Total 7x7 pose information of the currently matched set
    (reference: the running curMat in runActiveMapMatching)."""
    M = info_matrices(q, p, pts, fx, fy, bf, stereo_mask, inv_sigma2, valid)
    return M.sum(0)


def selection_state(R0, t0, pred_octave, scales):
    """The pose Tcw (R0, t0) as the selection's state — the quaternion of
    R0ᵀ and the camera centre — and each pool row's inverse level variance
    1/scale² at its predicted octave, clamped to the pyramid."""
    R_wc = R0.T
    q_wc = lie.rot_to_quat(R_wc)
    center = -(R_wc @ t0)
    inv2 = 1.0 / scales[torch.clamp(pred_octave, 0, scales.shape[0] - 1)] ** 2
    return q_wc, center, inv2


def pose_info_for_selection(R0, t0, pos, pred_octave, valid, scales, kp_mp_pos,
                            kp_mp_valid, fx, fy, bf, stereo: bool):
    """The good-feature selection's inputs at the pose Tcw (R0, t0): the
    pool's [P,7,7] information matrices (rows `pos` at `pred_octave`, zero
    where not `valid`) and the [7,7] information of the matched keypoints
    (`kp_mp_pos` where `kp_mp_valid`, weight 1); `stereo` keeps the u_right
    rows. CUDA tensors launch the kernel once, then sum the keypoints'
    matrices with torch: the plain version's bits on the card (float32:
    anything else raises); CPU tensors run `pose_info_for_selection_ref`."""
    if pos.is_cuda:
        return obs_info(*(x.contiguous() for x in (R0, t0, pos, pred_octave, valid, scales,
                                                    kp_mp_pos, kp_mp_valid)),
                        fx, fy, bf, stereo)
    return pose_info_for_selection_ref(R0, t0, pos, pred_octave, valid, scales, kp_mp_pos,
                                       kp_mp_valid, fx, fy, bf, stereo)


def pose_info_for_selection_ref(R0, t0, pos, pred_octave, valid, scales, kp_mp_pos,
                                kp_mp_valid, fx, fy, bf, stereo: bool):
    """Plain PyTorch version of `pose_info_for_selection` (any device)."""
    q_wc, center, inv2 = selection_state(R0, t0, pred_octave, scales)
    dev = pos.device
    n = kp_mp_pos.shape[0]
    obs = info_matrices(q_wc, center, pos, fx, fy, bf,
                        torch.full((pos.shape[0],), stereo, device=dev), inv2, valid)
    base = pose_info_from_frame(q_wc, center, kp_mp_pos, fx, fy, bf,
                                torch.full((n,), stereo, device=dev),
                                torch.ones(n, dtype=pos.dtype, device=dev), kp_mp_valid)
    return obs, base


def measurement_jacobians_13(q, p, pts, fx, fy, bf, stereo_mask):
    """Hybrid full-state Jacobian H [P,3,13] over Xv = [p,q,v,ω]
    (reference: USE_HYBRID_INFO_MATRIX, Tracking.cc:271-274 size 13).
    Velocity/rate columns are zero at the measurement instant — they gain
    rank through the kinematic transition (see `som_matrices`) or the
    kinematic prior in `info_matrices_13`."""
    H7, pc = measurement_jacobians(q, p, pts, fx, fy, bf, stereo_mask)
    z6 = torch.zeros(H7.shape[:-1] + (6,), dtype=H7.dtype, device=H7.device)
    return torch.cat([H7, z6], -1), pc


def info_matrices_13(q, p, pts, fx, fy, bf, stereo_mask, inv_sigma2, valid,
                     kine_prior: float = 1e2):
    """Per-landmark 13x13 hybrid information matrices: measurement info on
    the pose block + a kinematic prior on the velocity/rate block (the
    reference's hybrid mode folds the propagated kinematic covariance in;
    a diagonal prior keeps the matrix full-rank with the same selection
    ordering on the pose block)."""
    H, pc = measurement_jacobians_13(q, p, pts, fx, fy, bf, stereo_mask)
    w = (valid & (pc[..., 2] > 1e-3)).to(H.dtype) * inv_sigma2
    M = (H * w[:, None, None]).transpose(1, 2) @ H
    prior = torch.cat([torch.zeros(7, dtype=M.dtype, device=M.device),
                       torch.full((6,), kine_prior, dtype=M.dtype, device=M.device)])
    return M + torch.diag(prior)[None]


def som_matrices(q, p, v, w_rate, dts, pts, fx, fy, bf, stereo_mask):
    """Stripe observability matrix over a PWLS segment chain
    (reference: Observability::compute_SOM_In_Segment Observability.cc:34):
    SOM = [H(x₀); H(x₁)F₁; H(x₂)F₂F₁; ...] with the 13-state constant-
    velocity transition. Returns [P, 3·n, 13] for n = len(dts) segments.
    """
    st = KineState(p=p, q=q, v=v, w=w_rate)
    Phi = torch.eye(13, dtype=pts.dtype, device=pts.device)
    stripes = []
    for dt in dts:
        H, _ = measurement_jacobians_13(st.q, st.p, pts, fx, fy, bf, stereo_mask)
        stripes.append(H @ Phi)
        F = process_jacobian(st, dt)
        Phi = F @ Phi
        st = predict(st, dt)
    return torch.cat(stripes, 1)


def _chol_logdet_unrolled(M, eps=1e-6):
    """log|M| of small PSD matrices [..., D, D] via fully-unrolled Cholesky.

    LAPACK-style slogdet kernels have large fixed costs per invocation —
    deadly inside the greedy selection loop (one call per round). The
    unrolled Crout recursion is ~D²/2 elementwise ops over the batch.
    D is static and small (7/13).
    """
    D = M.shape[-1]
    L = [[None] * D for _ in range(D)]
    logdet = 0.0
    for j in range(D):
        acc = M[..., j, j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        djj = torch.sqrt(torch.clamp(acc, min=eps))
        L[j][j] = djj
        logdet = logdet + 2.0 * torch.log(djj)
        inv = 1.0 / djj
        for i in range(j + 1, D):
            a = M[..., i, j]
            for k in range(j):
                a = a - L[i][k] * L[j][k]
            L[i][j] = a * inv
    return logdet


def logdet_psd(M, eps=1e-3):
    """log-determinant of a PSD matrix (batched), f32-robust.

    The reference uses LU-based logDet in double precision
    (Observability.h:85); in f32 the raw determinant underflows/overflows for
    info matrices whose diagonal spans ~1e5..1e8, so we scale-normalize by
    the diagonal first: logdet(M) = logdet(D^-½ M D^-½) + Σ log dᵢ.
    Small static D (≤16) uses the unrolled Cholesky and sums the log-scales
    left to right, every operation rounded on its own: the order the
    selection kernel (csrc/greedy_select.cu) takes, so its scores equal
    these on the card bit for bit; larger D falls back to slogdet.
    """
    d = M.shape[-1]
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    s = torch.sqrt(torch.clamp(diag, min=eps))
    Mn = M / (s[..., :, None] * s[..., None, :])
    Mn = Mn + 1e-5 * torch.eye(d, dtype=M.dtype, device=M.device)
    if d > 16:
        return torch.linalg.slogdet(Mn)[1] + 2.0 * torch.sum(torch.log(s), -1)
    log_s = torch.log(s)
    total = log_s[..., 0]
    for i in range(1, d):
        total = total + log_s[..., i]
    return _chol_logdet_unrolled(Mn) + 2.0 * total
