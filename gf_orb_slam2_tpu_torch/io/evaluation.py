"""Trajectory evaluation: ATE / RPE against ground truth.

The reference validates by running benchmark sequences and inspecting the
saved trajectories with external evo-style tooling (reference:
README.md:85-103, batch_scripts/Run_Robot_Stereo.py); this module makes the
evaluation first-party: TUM-format loading, timestamp association, SE3 (or
Sim3) Umeyama alignment, ATE RMSE and RPE statistics.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def load_tum(path) -> Tuple[np.ndarray, np.ndarray]:
    """TUM format: `t tx ty tz qx qy qz qw` → (stamps [N], positions [N,3],
    quaternions [N,4] xyzw)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 8:
                continue
            rows.append([float(x) for x in parts[:8]])
    arr = np.asarray(rows, np.float64)
    if arr.size == 0:
        return np.empty(0), np.empty((0, 3)), np.empty((0, 4))
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association a→b within max_dt; returns index pairs."""
    if t_a.size == 0 or t_b.size == 0:
        return np.empty(0, int), np.empty(0, int)
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    left = np.abs(t_b[j - 1] - t_a)
    right = np.abs(t_b[j] - t_a)
    jj = np.where(left < right, j - 1, j)
    ok = np.abs(t_b[jj] - t_a) <= max_dt
    return np.nonzero(ok)[0], jj[ok]


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares s,R,t with dst ≈ s·R·src + t (Umeyama)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray,
             with_scale: bool = False) -> float:
    """Absolute trajectory error after alignment (RMSE, meters)."""
    s, R, t = umeyama_align(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = np.linalg.norm(aligned - gt_pos, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe_stats(est_pos: np.ndarray, gt_pos: np.ndarray, delta: int = 1):
    """Relative pose (translation drift) error statistics per `delta` steps."""
    de = est_pos[delta:] - est_pos[:-delta]
    dg = gt_pos[delta:] - gt_pos[:-delta]
    err = np.linalg.norm(de - dg, axis=1)
    return dict(rmse=float(np.sqrt((err ** 2).mean())),
                mean=float(err.mean()), max=float(err.max()))


def evaluate_tum_files(est_path, gt_path, max_dt: float = 0.02,
                       with_scale: bool = False) -> dict:
    """End-to-end: load two TUM files, associate, align, report."""
    t_e, p_e, _ = load_tum(est_path)
    t_g, p_g, _ = load_tum(gt_path)
    ie, ig = associate(t_e, t_g, max_dt)
    if ie.size < 3:
        return dict(n_pairs=int(ie.size), ate_rmse=float("nan"))
    out = dict(
        n_pairs=int(ie.size),
        ate_rmse=ate_rmse(p_e[ie], p_g[ig], with_scale),
    )
    out.update({f"rpe_{k}": v for k, v in rpe_stats(p_e[ie], p_g[ig]).items()})
    return out
