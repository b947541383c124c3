"""Monocular map initialization: batched H/F RANSAC + motion recovery.

Replacement for the Initializer class (reference: src/Initializer.cc —
two std::threads compute a homography and a fundamental matrix RANSAC in
parallel (Initializer.cc:44), score them, pick by the SH/(SH+SF) ratio and
recover the motion by Faugeras (H) or the essential matrix (F)).

All hypotheses of BOTH models run as one batched program: [S,8] minimal
sets, batched normalized DLT by eigh of AᵀA, batched symmetric-transfer and
epipolar scoring, argmax, a weighted refit of each winner on its inliers.
Motion recovery is batched too: E = KᵀFK gives 4 (R,t) candidates, the
homography's SVD decomposition 8, and one batched triangulation of every
match under all 8 candidates votes on cheirality (geometry/triangulate.py).
Every decision stays a tensor (`torch.where`), so the caller reads the
result back once.

The draws are an input: `initialize` takes explicit `draws` [n_hyp,8]
(indices into the valid matches in their order, the stable order of
`argsort(~valid)`) or a `torch.Generator` to draw them from.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam2_tpu_torch.geometry import triangulate
from gf_orb_slam2_tpu_torch.tracking.pnp import det3, draw_hypotheses, valid_first

SIGMA = 1.0
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # reference: both scores accumulate (th - chi2) capped
N_HYP = 256
SAMPLE = 8


class InitResult(NamedTuple):
    ok: torch.Tensor          # [] bool
    R: torch.Tensor           # [3,3] cam2←cam1 (world = cam1)
    t: torch.Tensor           # [3] unit-norm translation
    points: torch.Tensor      # [N,3] triangulated in cam1 frame
    is_inlier: torch.Tensor   # [N] bool (triangulated + checks)
    used_h: torch.Tensor      # [] bool — which model won


def _normalize(uv, valid):
    """Isotropic normalization (reference: Initializer::Normalize)."""
    n = torch.clamp(torch.sum(valid), min=1).to(uv.dtype)
    mean = torch.sum(torch.where(valid[:, None], uv, 0.0), 0) / n
    d = torch.where(valid[:, None], uv - mean, 0.0)
    mean_dev = torch.sum(torch.abs(d), 0) / n
    s = 1.0 / torch.clamp(mean_dev, min=1e-6)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return d * s, T


def _smallest_eigvec(A):
    """[..,9,9] symmetric → [..,3,3] eigenvector of its smallest eigenvalue
    (sign as the solver gives it: every user is sign-invariant)."""
    return torch.linalg.eigh(A)[1][..., :, 0].reshape(A.shape[:-2] + (3, 3))


def _dlt_homography(p1, p2, w=None):
    """[..,N,2]×[..,N,2] (opt. weights [..,N]) → H (p2 ≈ H p1) via eigh of
    AᵀA."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    A = torch.cat([r1, r2], -2)
    if w is not None:
        A = A * torch.cat([w, w], -1)[..., None]
    return _smallest_eigvec(A.transpose(-1, -2) @ A)


def _dlt_fundamental(p1, p2, w=None):
    """Normalized 8-point (or weighted all-point refit): F, rank 2 enforced."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], -1)
    if w is not None:
        A = A * w[..., None]
    F = _smallest_eigvec(A.transpose(-1, -2) @ A)
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return (U * S[..., None, :]) @ Vt


def _hom(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], -1)


def _score_h(H, uv1, uv2, valid, sigma2=SIGMA ** 2):
    """Symmetric transfer error score (reference: CheckHomography), batched
    over H [..,3,3]. Returns (score [..], inliers [..,N])."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv_ex(H + 1e-12 * eye)[0]

    def transfer(M, a):
        b = _hom(a) @ M.transpose(-1, -2)
        w = b[..., 2:]
        return b[..., :2] / torch.where(torch.abs(w) < 1e-9, 1e-9, w)

    e12 = torch.sum((transfer(H, uv1) - uv2) ** 2, -1) / sigma2
    e21 = torch.sum((transfer(Hinv, uv2) - uv1) ** 2, -1) / sigma2
    in12 = e12 < CHI2_H
    in21 = e21 < CHI2_H
    score = (torch.where(valid & in12, SCORE_TH - e12, 0.0)
             + torch.where(valid & in21, SCORE_TH - e21, 0.0))
    return torch.sum(score, -1), valid & in12 & in21


def _score_f(F, uv1, uv2, valid, sigma2=SIGMA ** 2):
    """Epipolar distance score (reference: CheckFundamental), batched over
    F [..,3,3]."""
    ah1, ah2 = _hom(uv1), _hom(uv2)
    l2 = ah1 @ F.transpose(-1, -2)  # lines in image 2
    d2 = (torch.sum(l2 * ah2, -1) ** 2
          / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / sigma2)
    l1 = ah2 @ F
    d1 = (torch.sum(l1 * ah1, -1) ** 2
          / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / sigma2)
    in2 = d2 < CHI2_F
    in1 = d1 < CHI2_F
    score = (torch.where(valid & in2, SCORE_TH - d2, 0.0)
             + torch.where(valid & in1, SCORE_TH - d1, 0.0))
    return torch.sum(score, -1), valid & in1 & in2


def _unit(t):
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-9)


def _decompose_E(E):
    """E → 4 candidate (R, t) (reference: DecomposeE Initializer.cc:917)."""
    U, _, Vt = torch.linalg.svd(E)
    d = det3(U) * det3(Vt)
    U = U * torch.where(d < 0, -1.0, 1.0)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(det3(R1))
    R2 = R2 * torch.sign(det3(R2))
    t = _unit(U[:, 2])
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H, K):
    """H → 8 candidate (R, t) via the SVD method (Faugeras; reference:
    ReconstructH Initializer.cc:577), the 8 cases built at once: the four
    sign patterns of (x1, x3) for d' > 0, then for d' < 0."""
    A = torch.linalg.inv_ex(K)[0] @ H @ K
    U, w, Vt = torch.linalg.svd(A)
    s = det3(U) * det3(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    dev, dt = H.device, H.dtype
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2)
                                  / torch.clamp(d1 * d1 - d3 * d3, min=1e-12), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3)
                                  / torch.clamp(d1 * d1 - d3 * d3, min=1e-12), min=0.0))
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    es = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dt, device=dev)
    x1s, x3s = aux1 * e1, aux3 * e3
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    # case d' > 0
    sin_t = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    # case d' < 0
    sin_p = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    z4, o4 = torch.zeros(4, dtype=dt, device=dev), torch.ones(4, dtype=dt, device=dev)
    st, sp = sin_t * es, sin_p * es
    ct, cp = cos_t * o4, cos_p * o4
    Rp = torch.cat([
        torch.stack([torch.stack([ct, z4, -st], -1), torch.stack([z4, o4, z4], -1),
                     torch.stack([st, z4, ct], -1)], -2),
        torch.stack([torch.stack([cp, z4, sp], -1), torch.stack([z4, -o4, z4], -1),
                     torch.stack([sp, z4, -cp], -1)], -2)])            # [8,3,3]
    tp = torch.cat([torch.stack([x1s, z4, -x3s], -1) * (d1 - d3),
                    torch.stack([x1s, z4, x3s], -1) * (d1 + d3)])      # [8,3]
    Rs = s * (U @ Rp @ Vt)
    ts = _unit((U @ tp[..., None])[..., 0])
    return Rs, ts


def _cheirality_vote(Rs, ts, K, uv1, uv2, valid, min_parallax_cos=0.99995):
    """Triangulate every match under each candidate at once, count points in
    front of both cameras with parallax (reference: CheckRT
    Initializer.cc:805). Returns (best_idx, votes [C], points [C,N,3],
    good [C,N])."""
    dev, dt = K.device, K.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    zero = torch.zeros(3, dtype=dt, device=dev)
    P1 = triangulate.projection_matrix(K, eye, zero)
    P2 = triangulate.projection_matrix(K, Rs, ts)                   # [C,3,4]
    X = triangulate.triangulate_dlt(P1, P2[:, None], uv1, uv2)      # [C,N,3]
    ones = torch.ones(uv1.shape[0], dtype=dt, device=dev)
    good = triangulate.triangulation_checks(
        X, eye, zero, Rs[:, None], ts[:, None], uv1, uv2, K, ones, ones,
        min_parallax_cos=min_parallax_cos, chi2=4.0 * CHI2_H) & valid
    votes = torch.sum(good, -1)
    return torch.argmax(votes), votes, X, good


def initialize(
    uv1, uv2, valid, K, draws=None, generator=None, n_hyp: int = N_HYP,
    min_inliers: int = 50, min_triangulated: int = 50,
):
    """Full two-view bootstrap (reference: Initializer::Initialize
    Initializer.cc:44). uv1/uv2: matched undistorted pixels [N,2]; valid:
    [N]; `draws` [n_hyp,8] indices into the valid matches in their order,
    else drawn from `generator`.

    Returns InitResult. The winning model follows the reference's
    RH = SH/(SH+SF) > 0.40 rule (Initializer.cc:105)."""
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)
    T2inv = torch.linalg.inv_ex(T2)[0]

    # minimal sets from the valid matches, in their order (a STABLE sort, as
    # the JAX argsort); a draw past the end is clamped, as JAX clamps
    idx_valid = valid_first(valid)
    if draws is None:
        draws = draw_hypotheses(valid.sum(), generator, n_hyp, SAMPLE)
    samples = idx_valid[torch.clamp(draws.to(uv1.device), 0, uv1.shape[0] - 1)]  # [S,8]
    p1s, p2s = n1[samples], n2[samples]

    Hs = T2inv @ _dlt_homography(p1s, p2s) @ T1          # denormalized [S,3,3]
    Fs = T2.T @ _dlt_fundamental(p1s, p2s) @ T1
    h_scores, h_inl = _score_h(Hs, uv1, uv2, valid)
    f_scores, f_inl = _score_f(Fs, uv1, uv2, valid)
    bh = torch.argmax(h_scores)  # first maximum, as jnp.argmax
    bf = torch.argmax(f_scores)
    # refit each winning model on all of its inliers (the reference refines
    # by re-scoring; an inlier least-squares refit is strictly better)
    H_ref = T2inv @ _dlt_homography(n1, n2, h_inl[bh].to(n1.dtype)) @ T1
    F_ref = T2.T @ _dlt_fundamental(n1, n2, f_inl[bf].to(n1.dtype)) @ T1
    SH, h_inl_ref = _score_h(H_ref, uv1, uv2, valid)
    SF, f_inl_ref = _score_f(F_ref, uv1, uv2, valid)
    RH = SH / torch.clamp(SH + SF, min=1e-9)
    use_h = RH > 0.40

    Rs_h, ts_h = _decompose_H(H_ref, K)
    Rs_f, ts_f = _decompose_E(K.T @ F_ref @ K)
    # pad F's 4 candidates to 8 with degenerate (zero-baseline) entries that
    # collect no cheirality votes — duplication would defeat the
    # clear-winner test below
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    Rs_f8 = torch.cat([Rs_f, eye.expand(4, 3, 3)])
    ts_f8 = torch.cat([ts_f, torch.zeros_like(ts_f)])
    Rs = torch.where(use_h, Rs_h, Rs_f8)
    ts = torch.where(use_h, ts_h, ts_f8)
    model_inl = torch.where(use_h, h_inl_ref, f_inl_ref)

    best, votes, X, good = _cheirality_vote(Rs, ts, K, uv1, uv2, model_inl)
    n_good = votes[best]
    # acceptance (reference: nGood > 0.9*nInliers-ish, second-best clearly
    # worse, enough triangulated)
    second = torch.sort(votes).values[-2]
    distinct = n_good > 1.5 * second  # a clear winner among candidates
    ok = ((torch.sum(model_inl) >= min_inliers) & (n_good >= min_triangulated)
          & distinct)
    return InitResult(ok=ok, R=Rs[best], t=ts[best], points=X[best],
                      is_inlier=good[best], used_h=use_h)
