"""Good-graph selection: budget-aware KF subset for local BA.

Replacement for the SLAM++ good-graph solver (reference:
Thirdparty/SLAM++/include/slam/NonlinearSolver_GoodGraph.h — Schur-complement
the landmarks out to the pose-only SC matrix (:978-1047), then
LazierGreedy_Selection (:1056) picks the KF subset maximizing logDet by
incremental block Cholesky (:1181-1218); driven from
Optimizer::LocalBundleAdjustment via CBAOptimizer::Find_Subgraph
(Optimizer.cc:1156)).

The pose-block Schur complement comes from optim/local_ba.pose_schur_blocks;
the greedy rounds are a Python loop whose every decision stays a tensor, so
no round waits for the host.
"""
from __future__ import annotations

import torch

from gf_orb_slam2_tpu_torch.selection.observability import logdet_psd


def _blocks_to_matrix(S_blocks):
    """[..,K,K,6,6] → [..,6K,6K] (row-major over KFs)."""
    K = S_blocks.shape[-3]
    return S_blocks.transpose(-3, -2).reshape(S_blocks.shape[:-4] + (K * 6, K * 6))


def masked_logdet(S_blocks, mask, eps=1e-3):
    """logdet of S restricted to the selected KFs.

    S_blocks: [K,K,6,6]; mask: [..,K] bool. Unselected rows/cols are zeroed
    and their diagonal set to identity, so the determinant equals that of the
    selected submatrix.
    """
    K = S_blocks.shape[0]
    m = mask.to(S_blocks.dtype)
    Sm = S_blocks * m[..., :, None, None, None] * m[..., None, :, None, None]
    eye6 = torch.eye(6, dtype=S_blocks.dtype, device=S_blocks.device)
    ar = torch.arange(K, device=S_blocks.device)
    Sm = Sm.clone()
    Sm[..., ar, ar, :, :] += (1.0 - m)[..., :, None, None] * eye6
    return logdet_psd(_blocks_to_matrix(Sm), eps)


def _chol6(M, eps=1e-9):
    """Unrolled 6x6 Cholesky (batched). Returns lower-triangular L and
    Σ log diag(L) (half the logdet)."""
    d = M.shape[-1]
    cols = []  # column j of L, [..,d]
    logdiag = torch.zeros(M.shape[:-2], dtype=M.dtype, device=M.device)
    for j in range(d):
        L = torch.stack(cols, -1) if cols else M[..., :, :0]  # [..,d,j]
        s = M[..., j, j] - torch.sum(L[..., j, :] ** 2, -1)
        dj = torch.sqrt(torch.clamp(s, min=eps))
        logdiag = logdiag + torch.log(dj)
        below = (M[..., j + 1:, j]
                 - torch.sum(L[..., j + 1:, :] * L[..., None, j, :], -1)) / dj[..., None]
        cols.append(torch.cat([torch.zeros_like(M[..., :j, j]), dj[..., None], below], -1))
    return torch.stack(cols, -1), logdiag


def _solve_lower6(L, rhs):
    """Forward substitution y = L⁻¹ rhs for a 6x6 lower L and a [6, M] rhs."""
    ys = []
    for j in range(6):
        acc = rhs[j]
        for i in range(j):
            acc = acc - L[j, i] * ys[i]
        ys.append(acc / L[j, j])
    return torch.stack(ys)


def select_subgraph(
    S_blocks, free_mask, n_select: int, generator=None, lazier_factor: int = 4,
    always_keep=None, eps: float = 1e-3, n_max: int = None, uniforms=None,
):
    """Greedy Max-logDet selection of `n_select` keyframes by incremental
    block Cholesky (the reference's GetLogDetInc scheme, SLAM++
    NonlinearSolver_GoodGraph.h:1181-1218).

    Keeps X = L⁻¹ S[A,:] across rounds (L = chol(S[A,A]) over the selected
    ordering A). Appending KF j adds six rows Lc⁻¹(S[j,:] − X_jᵀX); earlier
    rows never change. Every round scores all K candidates with one batched
    6×6 Cholesky of Δ_j = S_jj − X_jᵀX_j.

    S_blocks: [K,K,6,6] pose-Schur information; free_mask: [K] selectable;
    always_keep: [K] bool, selected first; `n_max` (≥ n_select) rounds run.
    The lazier sampling draws one U(0,1) per candidate and round from
    `generator`, or takes them from `uniforms` [n_max, K] (tests).
    Returns the selected mask [K].
    """
    K = S_blocks.shape[0]
    dev, dt = S_blocks.device, S_blocks.dtype
    if n_max is None:
        n_max = int(n_select)
    if always_keep is None:
        always_keep = torch.zeros(K, dtype=torch.bool, device=dev)
    if uniforms is None:
        uniforms = torch.rand((n_max, K), generator=generator, device=dev, dtype=dt)
    N6 = 6 * n_max
    ar = torch.arange(K, device=dev)
    # diagonal scale-normalization (f32: info diagonals span ~1e5..1e8)
    dscale = torch.sqrt(torch.clamp(
        torch.diagonal(S_blocks[ar, ar], dim1=-2, dim2=-1), min=eps))  # [K,6]
    Sn = S_blocks / (dscale[:, None, :, None] * dscale[None, :, None, :])
    Sn = Sn.clone()
    Sn[ar, ar] += 1e-5 * torch.eye(6, dtype=dt, device=dev)
    Srows = _blocks_to_matrix(Sn).reshape(K, 6, K * 6)  # Srows[j] = S[j-block rows, :]
    Sdiag = Sn[ar, ar]

    selected = torch.zeros(K, dtype=torch.bool, device=dev)
    X = torch.zeros((N6, K * 6), dtype=dt, device=dev)  # L⁻¹ S[A,:] in selection order
    n_sel = torch.zeros((), dtype=torch.int64, device=dev)
    forced = always_keep & free_mask
    inv_l = 1.0 / max(lazier_factor, 1)
    for r in range(n_max):
        Xb = X.reshape(N6, K, 6)
        G = torch.einsum("nka,nkb->kab", Xb, Xb)
        Lc, logd = _chol6(Sdiag - G)          # [K,6,6], [K] (½ logdet gains)
        cand = free_mask & ~selected & (uniforms[r] < inv_l)
        cand = torch.where(cand.any(), cand, free_mask & ~selected)
        cand = torch.where((forced & ~selected).any(), forced & ~selected, cand)
        score = torch.where(cand, logd, float("-inf"))
        best = torch.argmax(score)            # first maximum on ties
        ok = torch.isfinite(score[best]) & (n_sel < n_select)
        # rows [6r, 6r+6) of X become Lc_best⁻¹ (S[best,:] − X_bestᵀ X)
        rhs = Srows[best] - Xb[:, best].T @ X  # [6, 6K]
        newrow = _solve_lower6(Lc[best], rhs)
        X[6 * r:6 * r + 6] = torch.where(ok, newrow, X[6 * r:6 * r + 6])
        selected = selected | (ok & (ar == best))
        n_sel = n_sel + ok.to(torch.int64)
    return selected


def estimate_kf_budget(time_budget_ms: float, c3=0.0028, c2=0.0, c1=0.7, c0=2.0) -> int:
    """Budget → subgraph-size predictor (reference: Optimizer::estimateKFNum
    Optimizer.cc:566 — cubic time model t(n) = c3·n³+c2·n²+c1·n+c0 in ms,
    inverted by scan)."""
    n = 2
    while n < 64:
        t = c3 * n**3 + c2 * n**2 + c1 * n + c0
        if t > time_budget_ms:
            break
        n += 1
    return max(2, n - 1)
