"""Lie-group math on torch tensors: quaternions, SO(3), SE(3), Sim(3).

Conventions (same as the JAX package's geometry/lie.py):

- Quaternions are Hamilton, [w, x, y, z], unit norm.
- Poses are world→camera transforms Tcw stored as (R [..,3,3], t [..,3]).
- All functions broadcast over leading batch dims and take no decisions on
  the host (no `.item()`), so they can sit inside device-side loops.
"""
from __future__ import annotations

import math

import torch

from gf_orb_slam2_tpu_torch.utils import linalg3
from gf_orb_slam2_tpu_torch.utils.linalg3 import solve3

_EPS = 1e-8


def _norm(x, keepdim=False):
    return torch.sqrt(torch.sum(x * x, -1, keepdim=keepdim))


# ---------------------------------------------------------------- quaternions
def quat_normalize(q):
    return q / torch.clamp(_norm(q, keepdim=True), min=_EPS)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        -1,
    )


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_to_rot(q):
    """Unit quaternion [w,x,y,z] → rotation matrix [..,3,3]."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        -2,
    )


def rot_to_quat(R):
    """Rotation matrix → unit quaternion [w,x,y,z]; branchless (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions, pick numerically best by largest pivot
    qw = torch.stack(
        [
            1.0 + tr,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        -1,
    )
    qw = torch.sqrt(torch.clamp(qw, min=_EPS)) * 0.5
    q0, q1, q2, q3 = qw.unbind(-1)
    c0 = torch.stack([q0, (m21 - m12) / (4 * q0), (m02 - m20) / (4 * q0), (m10 - m01) / (4 * q0)], -1)
    c1 = torch.stack([(m21 - m12) / (4 * q1), q1, (m01 + m10) / (4 * q1), (m02 + m20) / (4 * q1)], -1)
    c2 = torch.stack([(m02 - m20) / (4 * q2), (m01 + m10) / (4 * q2), q2, (m12 + m21) / (4 * q2)], -1)
    c3 = torch.stack([(m10 - m01) / (4 * q3), (m02 + m20) / (4 * q3), (m12 + m21) / (4 * q3), q3], -1)
    # first-occurrence argmax, written out so CPU and CUDA agree on ties
    n = torch.arange(4, device=R.device)
    is_max = qw >= qw.max(-1, keepdim=True).values
    # (no maximum at all — a NaN matrix — picks 3, as JAX's clamped gather)
    idx = torch.clamp(torch.where(is_max, n, 4).min(-1).values, max=3)
    cands = torch.stack([c0, c1, c2, c3], -2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    # canonical sign: w >= 0
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


# ---------------------------------------------------------------------- SO(3)
def hat(w):
    """[..,3] → skew-symmetric [..,3,3]."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def so3_exp(w):
    """Rodrigues: axis-angle [..,3] → R [..,3,3]; stable near 0."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-3
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A * W + B * W2


def so3_log(R):
    """R [..,3,3] → axis-angle [..,3]; stable near 0 and pi."""
    tr = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.acos(tr)
    vee = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        -1,
    )
    sin_t = torch.sin(theta)
    th = theta[..., None]
    small = th < 3e-2
    # near pi: fall back through quaternion log
    near_pi = th > (math.pi - 1e-3)
    scale = torch.where(small, 0.5 + th ** 2 / 12.0, th / torch.clamp(2.0 * sin_t[..., None], min=_EPS))
    w = vee * scale
    q = rot_to_quat(R)
    qv = q[..., 1:]
    qn = _norm(qv, keepdim=True)
    w_pi = qv / torch.clamp(qn, min=_EPS) * (2.0 * torch.atan2(qn, q[..., :1]))
    return torch.where(near_pi, w_pi, w)


# ---------------------------------------------------------------------- SE(3)
def _mv(M, v):
    """Batched matrix·vector: [..,i,j] × [..,j] → [..,i]."""
    return (M @ v[..., None])[..., 0]


def se3_matrix(R, t):
    """(R, t) → 4x4."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_inv(R, t):
    Ri = R.transpose(-1, -2)
    return Ri, -_mv(Ri, t)


def se3_compose(Ra, ta, Rb, tb):
    """T_a ∘ T_b  (apply b first)."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def _rotate(R, pts):
    """R·p for points [..,3]: one matrix for all points, or one per point."""
    if R.dim() == 2:
        return pts @ R.T
    return _mv(R, pts)


def transform(R, t, pts):
    """Apply T to points [..,3]."""
    return _rotate(R, pts) + t


def se3_exp(xi):
    """Twist [..,6] = [rho(3), phi(3)] → (R, t). Uses V(phi) for translation."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, -1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(phi)
    W2 = W @ W
    small = theta2 < 1e-3
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + B * W + C * W2
    return R, _mv(V, rho)


def se3_log(R, t):
    """(R, t) → twist [..,6]."""
    phi = so3_log(R)
    theta2 = torch.sum(phi * phi, -1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(phi)
    W2 = W @ W
    small = theta2 < 1e-3
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / theta2)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(W.shape)
    Vinv = eye - 0.5 * W + coef * W2
    return torch.cat([_mv(Vinv, t), phi], -1)


# ---------------------------------------------------------------------- Sim(3)
def sim3_apply(s, R, t, pts):
    """Similarity transform s·R·p + t (reference: g2o Sim3 map())."""
    return s[..., None] * _mv(R, pts) + t


def sim3_inv(s, R, t):
    si = 1.0 / torch.clamp(s, min=_EPS)
    Ri = R.transpose(-1, -2)
    return si, Ri, -si[..., None] * _mv(Ri, t)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta


def _sim3_V(phi, sigma):
    """The V(phi, sigma) of the Sim(3) exponential, t = V·rho: C·I + A·W +
    B·W² with the four-branch coefficient table of Sophus for small angle
    and/or small log-scale. Constants enter `torch.where` as tensors of
    phi's dtype: under torch.func a Python scalar's tangent would be
    float64."""
    s = torch.exp(sigma)
    theta = torch.sqrt(torch.clamp(torch.sum(phi * phi, -1), min=_EPS * _EPS))
    W = hat(phi)
    W2 = W @ W
    eps = 1e-3  # f32-safe: below this, general-branch cancellation dominates
    th_small = theta < eps
    sig_small = torch.abs(sigma) < eps
    th2 = theta * theta
    sig2 = sigma * sigma
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    one = torch.ones_like(sigma)
    C_ = torch.where(sig_small, one, (s - 1.0) / torch.where(sig_small, one, sigma))
    a_ = s * sin_t
    b_ = s * cos_t
    c_ = th2 + sig2
    A_gen = (a_ * sigma + (1.0 - b_) * theta) / torch.clamp(theta * c_, min=_EPS)
    A_sig0 = (1.0 - cos_t) / torch.clamp(th2, min=_EPS)
    A_th0 = ((sigma - 1.0) * s + 1.0) / torch.clamp(sig2, min=_EPS)
    B_gen = (C_ - ((b_ - 1.0) * sigma + a_ * theta) / torch.clamp(c_, min=_EPS)) / torch.clamp(th2, min=_EPS)
    B_sig0 = (theta - sin_t) / torch.clamp(th2 * theta, min=_EPS)
    B_th0 = ((0.5 * sig2 - sigma + 1.0) * s - 1.0) / torch.clamp(sig2 * sigma, min=_EPS)
    A_ = torch.where(sig_small, torch.where(th_small, 0.5 * one, A_sig0),
                     torch.where(th_small, A_th0, A_gen))
    B_ = torch.where(sig_small, torch.where(th_small, one / 6.0, B_sig0),
                     torch.where(th_small, B_th0, B_gen))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return C_[..., None, None] * eye + A_[..., None, None] * W + B_[..., None, None] * W2


def sim3_exp(xi):
    """7-dof twist [rho(3), phi(3), sigma] → (s, R, t) (Strasdat; replaces
    g2o/types/sim3.h exp)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return torch.exp(sigma), so3_exp(phi), _mv(_sim3_V(phi, sigma), rho)


def sim3_log(s, R, t):
    """(s, R, t) → 7-dof twist: the inverse of sim3_exp, rho solved from
    V·rho = t (3x3 adjugate solve: elementwise, so it batches under
    torch.func and never waits for the device)."""
    sigma = torch.log(torch.clamp(s, min=_EPS))
    phi = so3_log(R)
    rho = solve3(_sim3_V(phi, sigma), t)
    return torch.cat([rho, phi, sigma[..., None]], -1)


# ------------------------------------------------------------------ alignment
def horn_sim3(src, dst, fix_scale=False):
    """Closed-form similarity alignment dst ≈ s·R·src + t (Horn / Umeyama;
    replaces Sim3Solver::ComputeSim3, reference src/Sim3Solver.cc:~229).
    src, dst: [..., N, 3]. Returns (s, R, t). R = V·D·Uᵀ is unique where the
    SVD's signs are not."""
    mu_s = torch.mean(src, dim=-2, keepdim=True)
    mu_d = torch.mean(dst, dim=-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d
    H = sc.transpose(-1, -2) @ dc  # cross-covariance [...,3,3]
    U, S, Vt = linalg3.svd(H)
    Ut = U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(Vt.transpose(-1, -2) @ Ut))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = Vt.transpose(-1, -2) @ (D[..., :, None] * Ut)
    var_s = torch.sum(sc * sc, dim=(-1, -2))
    s_num = torch.sum(S * D, dim=-1)
    s = torch.ones_like(var_s) if fix_scale else s_num / torch.clamp(var_s, min=_EPS)
    t = mu_d[..., 0, :] - s[..., None] * _mv(R, mu_s[..., 0, :])
    return s, R, t


def average_quat(qs, weights=None):
    """Weighted chordal quaternion mean via the largest eigenvector of Σ w qqᵀ."""
    if weights is None:
        weights = torch.ones(qs.shape[:-1], dtype=qs.dtype, device=qs.device)
    M = torch.einsum("...n,...ni,...nj->...ij", weights, qs, qs)
    _, vecs = linalg3.eigh(M)
    q = vecs[..., -1]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
