"""Closed-form batched 3x3 linear algebra (adjugate / Cramer).

A 3x3 inverse or solve is a few fused multiply-adds per matrix, so it runs
as plain elementwise tensor arithmetic over any batch shape. The determinant
is clamped away from zero (`eps`): local BA inverts the damped per-point
Hessian blocks with `inv3`, and a near-singular block (a point seen from one
direction only) must give a large finite inverse, not inf/NaN — which is why
this stays the adjugate form and not `torch.linalg.inv`.
"""
from __future__ import annotations

import torch


def adjugate3(M):
    """Batched [..,3,3] adjugate (transpose of the cofactor matrix)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    row0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1)
    row1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1)
    row2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)
    return torch.stack([row0, row1, row2], -2)


def det3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _clamped_det(M, eps):
    det = det3(M)
    tiny = torch.where(det < 0, -eps, eps)
    return torch.where(torch.abs(det) < eps, tiny, det)


def inv3(M, eps: float = 1e-12):
    """Batched 3x3 inverse via adjugate/determinant."""
    return adjugate3(M) / _clamped_det(M, eps)[..., None, None]


def solve3(M, b, eps: float = 1e-12):
    """Batched 3x3 solve M x = b (Cramer via adjugate), written as an
    elementwise multiply-sum."""
    return (adjugate3(M) * b[..., None, :]).sum(-1) / _clamped_det(M, eps)[..., None]
