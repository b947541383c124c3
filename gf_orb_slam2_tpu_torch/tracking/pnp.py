"""PnP RANSAC: camera pose from 3D-2D matches without a prior pose.

Replacement for PnPsolver (reference: src/PnPsolver.cc — EPnP control-point
parametrization inside a sequential RANSAC loop with Gauss-Newton beta
refinement, used by Tracking::Relocalization Tracking.cc:2615). The whole
RANSAC is one batched program over the hypotheses: [S] 6-point EPnP solves
as batched eigh (control points from the sample's PCA frame with a
degeneracy floor, so near-planar scenes stay well-conditioned), the beta
cases N=1/N=2 refined by 5 Gauss-Newton steps on the 6 control-point
distance constraints (reference: compute_pose PnPsolver.cc:480,
gauss_newton :861), batched reprojection scoring, and a weighted EPnP refit
on the winning inliers. Every decision is a tensor (`torch.where`), so a
solve enqueues without reading anything back. The caller polishes the pose
with the LM pose optimizer (optim/pose_opt.py).

The draws are an input: `pnp_ransac` takes explicit `draws` [n_hyp,6]
(indices into the valid points in their order, the stable order of
`argsort(~valid)`) or a `torch.Generator` to draw them from on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam2_tpu_torch.utils import linalg3

_PAIR_I = (0, 0, 0, 1, 1, 2)
_PAIR_J = (1, 2, 3, 2, 3, 3)
N_HYP = 256
SAMPLE = 6


class PnPResult(NamedTuple):
    ok: torch.Tensor          # [] bool
    R: torch.Tensor           # [3,3]
    t: torch.Tensor           # [3]
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # [] int64


def det3(M):
    """Determinant of [..,3,3] by cofactors (no factorization, no sync)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def canonical_signs(D):
    """[..,3,3] column vectors → [..,1,3] signs that make each column's
    largest-magnitude component (the first among equals) positive."""
    pick = torch.gather(D, -2, D.abs().argmax(-2, keepdim=True))
    return torch.where(pick < 0, -1.0, 1.0).to(D.dtype)


def _kabsch(X, Y, w):
    """Batched R, t with Y ≈ R X + t (Horn absolute orientation, no scale):
    X, Y [..,n,3], weights w [..,n]."""
    ws = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    cx = (X * w[..., None]).sum(-2) / ws
    cy = (Y * w[..., None]).sum(-2) / ws
    H = torch.einsum("...ni,...nj->...ij", (X - cx[..., None, :]) * w[..., None],
                     Y - cy[..., None, :])
    U, _, Vt = linalg3.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(det3(V @ Ut))
    one = torch.ones_like(d)
    R = V @ (torch.stack([one, one, d], -1)[..., :, None] * Ut)
    t = cy - (R @ cx[..., None])[..., 0]
    return R, t


def _lstsq_min_norm(A, b):
    """Minimum-norm least squares through the pseudo-inverse: singular
    values below eps·max(m,n)·σ_max count as zero, as jnp.linalg.lstsq's
    default — a rank-deficient A gives the same finite answer on every
    device (torch.linalg.lstsq on CUDA assumes full rank)."""
    m, n = A.shape[-2:]
    rtol = torch.finfo(A.dtype).eps * max(m, n)
    return (linalg3.pinv(A, rtol) @ b[..., None])[..., 0]


def _epnp_pose(Xw, uv_n, w):
    """EPnP for a batch of samples: Xw [B,n,3] world points, uv_n [B,n,2]
    normalized image coords, weights w [B,n] → (R [B,3,3], t [B,3]).

    Control points: sample centroid + PCA axes scaled by the point spread,
    floored at 5% of the largest axis — a valid affine frame even for planar
    samples (barycentric coordinates are exact for ANY non-degenerate
    tetrahedron; the floor only conditions the inversion). The axes' signs
    are fixed by `canonical_signs`; the JAX package keeps its LAPACK's.
    """
    B, n = Xw.shape[:2]
    dt, dev = Xw.dtype, Xw.device
    ws = torch.clamp(w.sum(-1), min=1e-9)[:, None]
    c0 = (Xw * w[..., None]).sum(1) / ws                      # [B,3]
    A = Xw - c0[:, None]
    cov = torch.einsum("bni,bnj->bij", A * w[..., None], A) / ws[..., None]
    lam, D = linalg3.eigh(cov)  # ascending; columns = axes
    # an axis's sign is the eigen solver's choice and moves the control
    # points, hence the pose of a noisy sample: fix it (largest component
    # positive), so every device builds the same frame
    D = D * canonical_signs(D)
    sc = torch.sqrt(torch.clamp(lam, min=0.0))
    floor = torch.clamp(0.05 * sc.max(-1).values, min=1e-3)
    sc = torch.maximum(sc, floor[:, None])
    Dt = D.transpose(-1, -2)
    Cw = torch.cat([c0[:, None], c0[:, None] + sc[..., None] * Dt], 1)   # [B,4,3]
    Bm = (Cw[:, 1:] - Cw[:, :1]).transpose(-1, -2)                       # [B,3,3]
    a123 = (torch.linalg.inv_ex(Bm)[0] @ A.transpose(-1, -2)).transpose(-1, -2)
    alpha = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], -1)     # [B,n,4]
    u, v = uv_n[..., 0:1], uv_n[..., 1:2]
    sw = torch.sqrt(torch.clamp(w, min=0.0))[..., None]
    zero = torch.zeros_like(alpha)
    Mu = torch.stack([alpha, zero, -u * alpha], -1).reshape(B, n, 12) * sw
    Mv = torch.stack([zero, alpha, -v * alpha], -1).reshape(B, n, 12) * sw
    M = torch.cat([Mu, Mv], 1)
    MtM = torch.einsum("bki,bkj->bij", M, M)
    _, vecs = linalg3.eigh(MtM)
    V = vecs[..., :4]                                         # 4 smallest
    Vr = V.transpose(-1, -2).reshape(B, 4, 4, 3)              # [B,k,ctrl,3]
    pi, pj = list(_PAIR_I), list(_PAIR_J)
    dCw = Cw[:, pi] - Cw[:, pj]                               # [B,6,3]
    rho = torch.sum(dCw * dCw, -1)                            # [B,6]
    dv = Vr[:, :, pi] - Vr[:, :, pj]                          # [B,4,6,3]
    dot = torch.einsum("bkpa,blpa->bpkl", dv, dv)             # [B,6,4,4]

    # ---- beta initializations (reference cases N=1 / N=2)
    d11 = dot[..., 0, 0]
    b1_n1 = torch.sqrt(torch.clamp(
        torch.sum(rho * d11, -1) / torch.clamp(torch.sum(d11 * d11, -1), min=1e-12),
        min=0.0))
    zeros2 = torch.zeros((B, 2), dtype=dt, device=dev)
    beta_n1 = torch.cat([b1_n1[:, None], zeros2, zeros2[:, :1]], -1)
    # N=2: least squares on [b11, b12, b22]
    L2 = torch.stack([dot[..., 0, 0], 2.0 * dot[..., 0, 1], dot[..., 1, 1]], -1)  # [B,6,3]
    sol2 = _lstsq_min_norm(L2, rho)
    b1 = torch.sqrt(torch.clamp(torch.abs(sol2[:, 0]), min=1e-12))
    b2 = torch.sqrt(torch.clamp(torch.abs(sol2[:, 2]), min=1e-12))
    b2 = b2 * torch.sign(sol2[:, 1]) * torch.sign(sol2[:, 0])
    beta_n2 = torch.cat([b1[:, None], b2[:, None], zeros2], -1)

    # both cases at once: [B,2,4], Gauss-Newton on the 6 distance
    # constraints (reference gauss_newton PnPsolver.cc:861), 5 steps
    beta = torch.stack([beta_n1, beta_n2], 1)
    eye4 = 1e-9 * torch.eye(4, dtype=dt, device=dev)
    for _ in range(5):
        Lb = torch.einsum("bpkl,bcl->bcpk", dot, beta)        # [B,2,6,4]
        r = torch.einsum("bcpk,bck->bcp", Lb, beta) - rho[:, None]
        J = 2.0 * Lb
        JtJ = torch.einsum("bcpi,bcpj->bcij", J, J) + eye4
        g = torch.einsum("bcpa,bcp->bca", J, r)
        beta = beta - torch.linalg.solve_ex(JtJ, g[..., None])[0][..., 0]

    # pose of each case: control points in the camera, points, Kabsch
    Cc = torch.einsum("bck,bkja->bcja", beta, Vr)            # [B,2,4,3]
    Xc = alpha[:, None] @ Cc                                  # [B,2,n,3]
    sgn = torch.sign(torch.sum(Xc[..., 2] * w[:, None], -1))  # [B,2]
    Xc = Xc * torch.where(sgn == 0, 1.0, sgn)[..., None, None]
    Xw2 = Xw[:, None].expand(B, 2, n, 3)
    w2 = w[:, None].expand(B, 2, n)
    Rs, ts = _kabsch(Xw2, Xc, w2)                             # [B,2,3,3], [B,2,3]
    pc = Xw2 @ Rs.transpose(-1, -2) + ts[..., None, :]
    z = torch.clamp(pc[..., 2], min=1e-6)
    e = torch.stack([pc[..., 0] / z - uv_n[:, None, :, 0],
                     pc[..., 1] / z - uv_n[:, None, :, 1]], -1)
    errs = torch.sum(torch.sum(e * e, -1) * w2, -1)           # [B,2]
    # argmin over the two cases as jnp.argmin: the first among equals, a
    # NaN counts as the minimum
    e0, e1 = errs[:, 0], errs[:, 1]
    best = (e1 < e0) | (torch.isnan(e1) & ~torch.isnan(e0))
    R = torch.where(best[:, None, None], Rs[:, 1], Rs[:, 0])
    t = torch.where(best[:, None], ts[:, 1], ts[:, 0])
    return R, t


def draw_hypotheses(n_valid, generator: torch.Generator, n_hyp: int = N_HYP,
                    sample: int = SAMPLE):
    """[n_hyp, sample] indices in [0, max(n_valid, sample)) on the
    generator's device. `n_valid` may be a tensor on that device: the draws
    are uniform floats scaled by it, so nothing is read back."""
    dev = generator.device
    hi = torch.clamp(torch.as_tensor(n_valid, device=dev), min=sample).to(torch.float32)
    u = torch.rand((n_hyp, sample), generator=generator, device=dev)
    return torch.minimum((u * hi).to(torch.int64), hi.to(torch.int64) - 1)


def valid_first(valid):
    """Indices of the valid entries first, each group in its order: a
    STABLE sort, as the JAX package's `argsort(~valid)` orders them."""
    return torch.sort((~valid).to(torch.int8), stable=True).indices


def _normalized(uv, fx, fy, cx, cy):
    return torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)


def epnp_hypotheses(Xw, uv, valid, fx, fy, cx, cy, draws):
    """The RANSAC's per-hypothesis EPnP poses: `draws` [S,6] index the valid
    points in their order; a draw past the end is clamped (a gather out of
    range is a device assert on CUDA, JAX clamps). Returns (R [S,3,3],
    t [S,3])."""
    samples = valid_first(valid)[torch.clamp(draws.to(Xw.device), 0, Xw.shape[0] - 1)]
    ones = torch.ones(samples.shape, dtype=Xw.dtype, device=Xw.device)
    return _epnp_pose(Xw[samples], _normalized(uv, fx, fy, cx, cy)[samples], ones)


def pnp_ransac(
    Xw, uv, valid, fx, fy, cx, cy, draws=None, generator=None,
    n_hyp: int = N_HYP, th_px: float = 5.0, min_inliers: int = 12,
):
    """Xw [N,3] world points matched to pixels uv [N,2]; valid [N].

    `draws` [n_hyp,6]: indices into the valid points in their order; without
    them they are drawn from `generator` (on the device, no read-back).
    Returns PnPResult; `ok` is a tensor."""
    if draws is None:
        draws = draw_hypotheses(valid.sum(), generator, n_hyp)
    Rs, ts = epnp_hypotheses(Xw, uv, valid, fx, fy, cx, cy, draws)

    def score(R, t):
        """[..,3,3], [..,3] → [.., N] inlier masks."""
        pc = Xw @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.clamp(pc[..., 2], min=1e-6)
        u = fx * pc[..., 0] / z + cx
        v = fy * pc[..., 1] / z + cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return valid & (e2 < th_px * th_px) & (pc[..., 2] > 0)

    inls = score(Rs, ts)                                      # [S,N]
    votes = torch.sum(inls, -1)
    best = torch.argmax(votes)  # first maximum, as jnp.argmax
    # weighted EPnP refit on the winning inliers (all points, masked)
    w = inls[best].to(Xw.dtype)
    R_f, t_f = _epnp_pose(Xw[None], _normalized(uv, fx, fy, cx, cy)[None], w[None])
    R_f, t_f = R_f[0], t_f[0]
    inl_f = score(R_f, t_f)
    better = torch.sum(inl_f) >= votes[best]
    inl_out = torch.where(better, inl_f, inls[best])
    n_out = torch.sum(inl_out)
    return PnPResult(ok=n_out >= min_inliers,
                     R=torch.where(better, R_f, Rs[best]),
                     t=torch.where(better, t_f, ts[best]),
                     inliers=inl_out, n_inliers=n_out)
