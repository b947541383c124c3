"""Camera projection / distortion / stereo rectification on torch tensors.

Replaces the reference's OpenCV-based calib path: cv::undistortPoints in
Frame::UndistortKeyPoints (reference: src/Frame.cc:670 UndistortKeyPointsStereo,
src/Tracking.cc:138-207 stereo LEFT/RIGHT K-D-R-P rectification) and the
fisheye branch (reference: include/Frame.h:43 USE_FISHEYE_DISTORTION).
Everything is batched; undistortion is a fixed-iteration Newton scheme.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PinholeCamera(NamedTuple):
    """Static camera parameters (reference: Util.hpp:134). Scalars stay
    Python floats; only the distortion vector lives on the device."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: torch.Tensor  # [5] k1 k2 p1 p2 k3
    width: int
    height: int
    fisheye: bool = False

    @staticmethod
    def from_config(cam, device="cuda") -> "PinholeCamera":
        return PinholeCamera(
            fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
            dist=torch.tensor(cam.dist, dtype=torch.float32, device=device),
            width=cam.width, height=cam.height, fisheye=cam.fisheye,
        )

    def K(self):
        """Intrinsics [3,3] f32 on the device of `dist`."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=self.dist.device)


def distort_radtan(xn, dist):
    """Normalized coords [..,2] → distorted normalized coords (rad-tan model)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def distort_fisheye(xn, dist):
    """Equidistant (KB4) fisheye distortion; dist[:4] = k1..k4."""
    x, y = xn[..., 0], xn[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-12))
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (dist[0] + t2 * (dist[1] + t2 * (dist[2] + t2 * dist[3]))))
    scale = theta_d / r
    return torch.stack([x * scale, y * scale], -1)


def undistort_normalized(xd, dist, fisheye=False, iters=8):
    """Invert distortion with fixed-point iterations at a fixed count
    (mirrors cv::undistortPoints' iterative scheme)."""
    distort = distort_fisheye if fisheye else distort_radtan
    x = xd
    for _ in range(iters):
        d = distort(x, dist) - x
        x = xd - d
    return x


def project(cam: PinholeCamera, pc, apply_distortion=False):
    """Camera-frame points [..,3] → pixel coords [..,2] (+ depth).

    Returns (uv, z). Frustum validity is the caller's mask: z > 0 and in-bounds.
    """
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    xn = pc[..., :2] * inv_z[..., None]
    if apply_distortion:
        xn = (distort_fisheye if cam.fisheye else distort_radtan)(xn, cam.dist)
    u = cam.fx * xn[..., 0] + cam.cx
    v = cam.fy * xn[..., 1] + cam.cy
    return torch.stack([u, v], -1), z


def backproject(cam: PinholeCamera, uv, z):
    """Pixels [..,2] + depth → camera-frame 3D (undistorted pinhole)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x * z, y * z, z], -1)


def stereo_unproject(cam: PinholeCamera, uv, disparity, bf):
    """Rectified keypoint + disparity → camera-frame 3D point.

    Reference: Frame::UnprojectStereo (src/Frame.cc:1629): z = bf / disparity.
    """
    z = bf / torch.clamp(disparity, min=1e-6)
    return backproject(cam, uv, z)


def undistort_keypoints(cam: PinholeCamera, uv):
    """Distorted pixel keypoints → undistorted pixel coords (same K).

    Reference: Frame::UndistortKeyPoints (src/Frame.cc:~630).
    """
    xn = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], -1
    )
    xu = undistort_normalized(xn, cam.dist, cam.fisheye)
    return torch.stack([xu[..., 0] * cam.fx + cam.cx, xu[..., 1] * cam.fy + cam.cy], -1)


class RectifyMap(NamedTuple):
    """Keypoint-level stereo rectification (reference: src/Frame.cc:670
    UndistortKeyPointsStereo applies per-camera K,D,R,P to raw keypoints).

    K: raw intrinsics [3,3]; D: [5]; R: rectifying rotation [3,3];
    P: rectified projection [3,4].
    """

    K: torch.Tensor
    D: torch.Tensor
    R: torch.Tensor
    P: torch.Tensor
    fisheye: bool = False

    @staticmethod
    def from_np(K, D, R, P, fisheye=False, device="cuda") -> "RectifyMap":
        D5 = np.zeros(5, np.float32)
        D = np.asarray(D, np.float32).ravel()
        D5[: min(5, D.size)] = D[:5]

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return RectifyMap(K=dev(K), D=dev(D5), R=dev(R), P=dev(P), fisheye=fisheye)


def rectify_keypoints(rm: RectifyMap, uv):
    """Raw distorted pixels → rectified pixels under (K,D,R,P)."""
    xn = torch.stack(
        [
            (uv[..., 0] - rm.K[0, 2]) / rm.K[0, 0],
            (uv[..., 1] - rm.K[1, 2]) / rm.K[1, 1],
        ],
        -1,
    )
    xu = undistort_normalized(xn, rm.D, rm.fisheye)
    rays = torch.cat([xu, torch.ones_like(xu[..., :1])], -1)
    rot = rays @ rm.R.T
    xr = rot[..., :2] / torch.clamp(rot[..., 2:3], min=1e-8)
    u = rm.P[0, 0] * xr[..., 0] + rm.P[0, 2]
    v = rm.P[1, 1] * xr[..., 1] + rm.P[1, 2]
    return torch.stack([u, v], -1)
