"""Device-side map-point projection & visibility (frustum) checks.

Replaces Frame::isInFrustum (reference: src/Frame.cc:535) and
MapPoint::PredictScale (src/MapPoint.cc:542) with one batched pass over the
whole candidate set: project, bounds-check, distance-range check, viewing
angle check, predicted pyramid level — all masked tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam2_tpu_torch.geometry import lie


class ProjectedPoints(NamedTuple):
    uv: torch.Tensor           # [P,2] pixel coords
    z: torch.Tensor            # [P] camera depth
    pred_octave: torch.Tensor  # [P] int64 predicted pyramid level
    visible: torch.Tensor      # [P] bool frustum+range+angle mask
    view_cos: torch.Tensor     # [P]


def project_points(
    R, t, pos, normal, min_dist, max_dist, valid,
    fx, fy, cx, cy, width, height,
    n_levels: int, log_scale: float,
    min_view_cos: float = 0.5, border: float = 0.0,
):
    """pos [P,3] world → ProjectedPoints under pose (R,t).

    min_view_cos: reference uses 0.5 both in SearchLocalPoints and isInFrustum.
    """
    pc = lie.transform(R, t, pos)
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    in_img = (
        (u >= border) & (u < width - border) & (v >= border) & (v < height - border)
    )
    # distance from camera center in world frame
    center = -(R.T @ t)
    pv = pos - center
    dist = torch.sqrt(torch.sum(pv * pv, -1))
    range_ok = (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
    n_norm = torch.sqrt(torch.sum(normal * normal, -1))
    vcos = torch.sum(pv * normal, -1) / torch.clamp(dist * n_norm, min=1e-9)
    angle_ok = vcos > min_view_cos
    # PredictScale: level = ceil(log(max_dist/dist)/log(scale))
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1.0)
    lvl = torch.ceil(torch.log(ratio) / log_scale).to(torch.int64)
    lvl = torch.clamp(lvl, 0, n_levels - 1)
    vis = valid & (z > 0) & in_img & range_ok & angle_ok
    return ProjectedPoints(torch.stack([u, v], -1), z, lvl, vis, vcos)
