"""Two-view triangulation + quality checks, batched over any leading dims.

Replaces the reference's per-point DLT in LocalMapping::CreateNewMapPoints
(src/LocalMapping.cc:370, SVD on a 4x4 A) with a batched closed-form solve
of the inhomogeneous normal equations, and its acceptance gates
(LocalMapping.cc:450-560) with elementwise masks.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.utils.linalg3 import solve3


def triangulate_dlt(P1, P2, x1, x2):
    """Batched linear (DLT) triangulation.

    P1, P2: [..,3,4] projection matrices; x1, x2: [..,2] pixel coordinates
    consistent with them. Returns [..,3] points: minimize ||A[X;1]||² in the
    w=1 gauge, (A₃ᵀA₃)X = -A₃ᵀa₄, one 3x3 solve per point.
    """
    rows = []
    for P, x in ((P1, x1), (P2, x2)):
        rows.append(x[..., 0, None] * P[..., 2, :] - P[..., 0, :])
        rows.append(x[..., 1, None] * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(torch.broadcast_tensors(*rows), -2)  # [..,4,4]
    A3 = A[..., :3]
    a4 = A[..., 3]
    AtA = torch.einsum("...ki,...kj->...ij", A3, A3)
    rhs = -torch.einsum("...ki,...k->...i", A3, a4)
    return solve3(AtA, rhs)


def projection_matrix(K, R, t):
    """P = K [R|t] for world→camera (R, t)."""
    return K @ torch.cat([R, t[..., None]], -1)


def triangulation_checks(
    Xw, R1, t1, R2, t2, uv1, uv2, K, sigma2_1, sigma2_2,
    min_parallax_cos=0.9998, chi2=5.991,
):
    """Cheirality + parallax + reprojection gates (reference:
    LocalMapping.cc:450-560): positive depth in both views, parallax cos
    below the threshold, reprojection chi2 within the per-octave sigma.
    Poses broadcast against the points' leading dims ([..,3,3] with [..,N,3]
    points: pass R[..., None, :, :]). Returns a boolean mask."""
    pc1 = lie.transform(R1, t1, Xw)
    pc2 = lie.transform(R2, t2, Xw)
    z_ok = (pc1[..., 2] > 0) & (pc2[..., 2] > 0)

    o1 = -torch.einsum("...ji,...j->...i", R1, t1)  # camera centres in world
    o2 = -torch.einsum("...ji,...j->...i", R2, t2)
    r1 = Xw - o1
    r2 = Xw - o2
    cosp = torch.sum(r1 * r2, -1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-9)
    parallax_ok = cosp < min_parallax_cos

    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]

    def reproj_err2(pc, uv):
        iz = 1.0 / torch.clamp(pc[..., 2], min=1e-8)
        u = fx * pc[..., 0] * iz + cx
        v = fy * pc[..., 1] * iz + cy
        return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2

    r_ok = (reproj_err2(pc1, uv1) < chi2 * sigma2_1) & (
        reproj_err2(pc2, uv2) < chi2 * sigma2_2)
    return z_ok & parallax_ok & r_ok
