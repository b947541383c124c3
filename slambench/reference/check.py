"""The plain reference that decides `correct`: the poses and the map that the
port returned, held against the trajectory and the hall that the benchmark
made from the seed.

NumPy only: it imports neither JAX nor anything of the port, and takes
nothing the port computed except the outputs it judges (the returned
poses, the keyframes' poses and frame ids, the map points). The ground truth
is worked out again here from the scene's definition: the camera path the
traffic's motion gives, and the box the hall is.

The numbers, each compared against a limit of its own where the cell's file
in `slambench/limits/` gives one (with the readings it was set from; a
number that has no limit there is printed only):

- `ate_m`: RMSE of the returned camera centres of the window's tracked
  frames against the true ones, after the rigid fit of the estimate's world
  onto the true one (`fit`, from the same frames' poses);
- `rpe_p95_m`: 95th percentile over those frames of the translation error
  of the camera's motion over one second (the relative pose error: no fit);
- `kf_ate_m`: the same RMSE over the map's keyframes at the run's end;
- `map_err_m`: median distance of the map's points from the hall's
  surfaces, after the keyframes' fit.

A run also has to return a tracked pose (not LOST) for at least 99 % of
the frames it was offered: every sound run on the card tracked all of them
(PERF.md §6), so a change that loses frames, which would leave the window
faster, is not correct.
"""
from __future__ import annotations

import numpy as np

MIN_TRACKED_SHARE = 0.99


def fit(T_cw, R_wc_gt, C_gt):
    """The rigid map from the estimate's world to the true one, from poses:
    the rotation nearest to the mean of R_wc_gt R_wc_est^T over the frames
    (orientations pin it down even where the centres lie on a line), then
    the translation that matches the mean centres."""
    R_wc = np.transpose(T_cw[:, :3, :3], (0, 2, 1))
    U, _, Vt = np.linalg.svd(np.einsum("nij,nkj->ik", R_wc_gt, R_wc))
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ S @ Vt
    return R, C_gt.mean(0) - R @ centres(T_cw).mean(0)


def centres(T_cw):
    """Camera centres [n,3] of world-to-camera poses [n,4,4]."""
    R, t = T_cw[:, :3, :3], T_cw[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def fit_rmse(T_cw, R_wc_gt, C_gt):
    """RMSE of the camera centres after the fit, and the fit."""
    R, t = fit(T_cw, R_wc_gt, C_gt)
    err = np.linalg.norm(centres(T_cw) @ R.T + t - C_gt, axis=1)
    return float(np.sqrt((err ** 2).mean())), (R, t)


def rpe(T_cw, R_wc_gt, C_gt, ids, step):
    """Translation errors of the motion over `step` frames, for every pair
    (i, i + step) of frames in `ids` (the error of the estimated relative
    motion expressed in the true frame i: no fit involved)."""
    pos = {int(i): k for k, i in enumerate(ids)}
    out = []
    for k, i in enumerate(ids):
        j = pos.get(int(i) + step)
        if j is None:
            continue
        ci, cj = centres(T_cw[[k, j]])
        d_est = T_cw[k, :3, :3] @ (cj - ci)
        d_gt = R_wc_gt[i].T @ (C_gt[i + step] - C_gt[i])
        out.append(np.linalg.norm(d_est - d_gt))
    return np.asarray(out)


def box_distance(P, W, H, L):
    """Distance of points [n,3] from the surface of the box [-W/2, W/2] x
    [-H/2, H/2] x [0, L]."""
    lo = np.array([-W / 2, -H / 2, 0.0])
    hi = np.array([W / 2, H / 2, L])
    inside = np.all((P >= lo) & (P <= hi), axis=1)
    d_in = np.minimum(P - lo, hi - P).min(1)
    excess = np.maximum(np.maximum(lo - P, P - hi), 0.0)
    return np.where(inside, d_in, np.linalg.norm(excess, axis=1))


def judge(out: dict, truth: dict, limits: dict) -> dict:
    """The numbers and the verdict.

    out: `T_cw` {frame id: 4x4} of the window's tracked frames, `attempted`,
    `kf_ids` [k] frame ids, `kf_T_cw` [k,4,4], `points` [m,3];
    truth: `R_wc` [n,3,3], `C` [n,3] (frame id = row), `fps`, `box` (W, H, L);
    limits: a limit for each number compared (the others are reported with
    the limit None).
    Returns {"correct": bool, "numbers": {name: (value, limit)}, "why": str}."""
    ids = np.array(sorted(out["T_cw"]), np.int64)
    share = len(ids) / max(out["attempted"], 1)
    numbers = {"tracked_share": (share, MIN_TRACKED_SHARE)}
    if len(ids) < 3 or share < MIN_TRACKED_SHARE:
        return {"correct": False, "numbers": numbers,
                "why": f"{len(ids)} tracked frames of {out['attempted']}"}
    T = np.stack([out["T_cw"][int(i)] for i in ids]).astype(np.float64)
    ate, _ = fit_rmse(T, truth["R_wc"][ids], truth["C"][ids])
    r = rpe(T, truth["R_wc"], truth["C"], ids, int(round(truth["fps"])))
    rpe95 = float(np.percentile(r, 95)) if len(r) else float("inf")
    numbers["ate_m"] = (ate, limits.get("ate_m"))
    numbers["rpe_p95_m"] = (rpe95, limits.get("rpe_p95_m"))
    kf_ids = np.asarray(out["kf_ids"], np.int64)
    if len(kf_ids) >= 3:
        kfT = np.asarray(out["kf_T_cw"], np.float64)
        kf_ate, (R, t) = fit_rmse(kfT, truth["R_wc"][kf_ids], truth["C"][kf_ids])
        P = np.asarray(out["points"], np.float64)
        dist = box_distance(P @ R.T + t, *truth["box"]) if len(P) else np.array([np.inf])
        numbers["kf_ate_m"] = (kf_ate, limits.get("kf_ate_m"))
        numbers["map_err_m"] = (float(np.median(dist)), limits.get("map_err_m"))
    else:
        numbers["kf_ate_m"] = (float("inf"), limits.get("kf_ate_m"))
    bad = [k for k, (v, lim) in numbers.items()
           if k != "tracked_share" and lim is not None and not (np.isfinite(v) and v <= lim)]
    return {"correct": not bad, "numbers": numbers,
            "why": "over the limit: " + ", ".join(bad) if bad else ""}
