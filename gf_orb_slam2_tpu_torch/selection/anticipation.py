"""Anticipation: future-visibility-driven local-BA budgeting.

Equivalent of the reference's anticipation machinery (reference:
Optimizer.cc:648-1131 — virtual future keyframes extrapolated from the
motion model, per-future-KF visible-map-point counts, and a local BA time
budget in [100, 800] ms derived from them; the budget feeds `estimateKFNum`
to size the good-graph subgraph, Optimizer.cc:1021-1131).

Host-side numpy: predicting a handful of poses and counting frustum
membership over the point array is microseconds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from gf_orb_slam2_tpu_torch.selection.good_graph import estimate_kf_budget


def predict_future_poses(R0, t0, velocity: Optional[np.ndarray], horizon: int):
    """Chain the constant-velocity relative motion: T_i = V^i ∘ T_0."""
    poses = []
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R0
    T[:3, 3] = t0
    V = np.eye(4, dtype=np.float32) if velocity is None else velocity
    for _ in range(horizon):
        T = V @ T
        poses.append((T[:3, :3].copy(), T[:3, 3].copy()))
    return poses


def visible_fraction(store, R, t, cam, sample: int = 4096) -> float:
    """Fraction of (sampled) valid map points inside the frustum at (R, t)."""
    ids = store.valid_point_ids()
    if ids.size == 0:
        return 0.0
    if ids.size > sample:
        ids = ids[:: max(1, ids.size // sample)]
    pc = store.point_pos[ids] @ R.T + t
    z = pc[:, 2]
    ok = z > 0.05
    zs = np.where(ok, z, 1.0)
    u = cam.fx * pc[:, 0] / zs + cam.cx
    v = cam.fy * pc[:, 1] / zs + cam.cy
    ok &= (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    return float(ok.mean())


def anticipated_subgraph_size(store, cfg, R0, t0,
                              velocity: Optional[np.ndarray]) -> int:
    """Budget policy: when the predicted future views keep most of the map
    visible (re-observation), local BA spends the full budget refining it;
    when visibility collapses (exploration), the subgraph shrinks so mapping
    keeps up with new territory (reference: Optimizer.cc:1011-1131)."""
    gg = cfg.good_graph
    cam = cfg.camera
    poses = predict_future_poses(R0, t0, velocity, gg.anticipation_horizon)
    if not poses:
        return gg.subgraph_size
    fracs = [visible_fraction(store, R, t, cam) for (R, t) in poses]
    vis = float(np.mean(fracs))
    budget = gg.budget_ms_min + vis * (gg.budget_ms_max - gg.budget_ms_min)
    n = estimate_kf_budget(budget)
    return int(np.clip(n, 2, gg.max_pool))
