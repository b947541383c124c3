"""Closed-form batched 3x3 linear algebra (adjugate / Cramer).

A 3x3 inverse or solve is a few fused multiply-adds per matrix, so it runs
as plain elementwise tensor arithmetic over any batch shape. The determinant
is clamped away from zero (`eps`): local BA inverts the damped per-point
Hessian blocks with `inv3`, and a near-singular block (a point seen from one
direction only) must give a large finite inverse, not inf/NaN — which is why
this stays the adjugate form and not `torch.linalg.inv`.

`eigh`, `svd` and `pinv` are torch's decompositions made to answer as
jnp.linalg's do on a matrix that is not finite: NaN for that matrix, where
torch raises. cuSOLVER and LAPACK report such a matrix as not converged, and
a raise ends the tracking thread on one degenerate input (an inf·0 in a
zero-weight row of a RANSAC refit). On finite input they are torch's own.
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


def _finite_or_eye(A):
    """A with every matrix that is not finite replaced by the identity, and
    the mask [..] of the finite ones."""
    ok = torch.isfinite(A).flatten(-2).all(-1)
    eye = torch.eye(A.shape[-2], A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where(ok[..., None, None], A, eye), ok


def _nan_unless(ok, x, k):
    """x with NaN where `ok` is false; x has `k` dims past ok's."""
    return torch.where(ok.reshape(ok.shape + (1,) * k), x, float("nan"))


def eigh(A):
    """torch.linalg.eigh, NaN for a matrix that is not finite."""
    A, ok = _finite_or_eye(A)
    lam, V = torch.linalg.eigh(A)
    return _nan_unless(ok, lam, 1), _nan_unless(ok, V, 2)


def svd(A):
    """torch.linalg.svd, NaN for a matrix that is not finite."""
    A, ok = _finite_or_eye(A)
    U, S, Vt = torch.linalg.svd(A)
    return _nan_unless(ok, U, 2), _nan_unless(ok, S, 1), _nan_unless(ok, Vt, 2)


def pinv(A, rtol):
    """torch.linalg.pinv, NaN for a matrix that is not finite."""
    A, ok = _finite_or_eye(A)
    return _nan_unless(ok, torch.linalg.pinv(A, rtol=rtol), 2)
