"""Constant-velocity kinematic state + piecewise-linear (PWLS) prediction.

Replacement for the Observability class's kinematic machinery (reference:
include/Observability.h:266 `predictPWLSVec`, the 13-dim state
Xv = [p(3), q(4), v(3), ω(3)], and the instantaneous/process Jacobians
tested by test/test_Kine_1.cpp and test_Kine_2.cpp). Used for:
- the stripe observability matrices of the 13-state selection
  (selection/observability.py `som_matrices`);
- the odometry buffer hooks (reference: BufferingOdom/PredictingOdom
  Tracking.cc:503/515 — planner-predicted motion via /desired_path), which
  replace the constant-velocity search-window prediction when fed.

The process Jacobian is forward-mode autodiff (utils/autodiff.row_jacobian:
one JVP per state column, on a batch of one row so that no traced tensor is
0-dim).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.geometry import lie
from gf_orb_slam2_tpu_torch.utils.autodiff import row_jacobian


class KineState(NamedTuple):
    """13-dim camera kinematic state (world frame; q is cam→world). Each
    field may carry leading batch dims."""

    p: torch.Tensor   # [..,3] position
    q: torch.Tensor   # [..,4] orientation quaternion [w,x,y,z]
    v: torch.Tensor   # [..,3] linear velocity
    w: torch.Tensor   # [..,3] angular velocity (body rates)

    def vector(self):
        return torch.cat([self.p, self.q, self.v, self.w], -1)

    @staticmethod
    def from_vector(x):
        return KineState(x[..., 0:3], x[..., 3:7], x[..., 7:10], x[..., 10:13])


def predict(state: KineState, dt) -> KineState:
    """Constant-velocity propagation over dt (reference: the CV model inside
    predictPWLSVec): p' = p + v·dt; q' = q ⊗ exp(ω·dt); v,ω unchanged."""
    dq = lie.rot_to_quat(lie.so3_exp(state.w * dt))
    return KineState(
        p=state.p + state.v * dt,
        q=lie.quat_normalize(lie.quat_mul(state.q, dq)),
        v=state.v,
        w=state.w,
    )


def predict_pwls(state: KineState, dts) -> KineState:
    """Multi-segment piecewise-linear prediction (reference: predictPWLSVec
    Observability.h:266 — chains segments for look-ahead horizons)."""
    out = state
    for dt in np.atleast_1d(dts):
        out = predict(out, float(dt))
    return out


def process_jacobian(state: KineState, dt):
    """13×13 Jacobian of the propagation (reference: the instantaneous
    kinematic Jacobians of test_Kine_1.cpp) via forward-mode autodiff."""

    def f(x):
        return predict(KineState.from_vector(x), dt).vector()

    return row_jacobian(f, state.vector()[None])[0]


def state_from_poses(R_prev, t_prev, R_cur, t_cur, dt) -> KineState:
    """Estimate the kinematic state from two consecutive Tcw poses (numpy)
    (reference: the motion-model update Tracking.cc:796-835)."""
    R_prev, t_prev = np.asarray(R_prev), np.asarray(t_prev)
    R_cur, t_cur = np.asarray(R_cur), np.asarray(t_cur)
    Rwc = R_cur.T
    p = -Rwc @ t_cur
    q = lie.rot_to_quat(torch.tensor(Rwc, dtype=torch.float32))
    p_prev = -R_prev.T @ t_prev
    v = (p - p_prev) / max(dt, 1e-6)
    # body rates: Rwc' = Rwc·exp(ŵdt) ⇒ ŵdt = log(Rwc_prevᵀ Rwc_cur)
    #           = log(R_prev · R_curᵀ)
    dR = R_prev @ R_cur.T
    w = lie.so3_log(torch.tensor(dR, dtype=torch.float32)) / max(dt, 1e-6)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)

    return KineState(p=f32(p), q=q.to(torch.float32), v=f32(v), w=w.to(torch.float32))


def pose_of(state: KineState):
    """KineState → world→cam (R, t)."""
    Rwc = lie.quat_to_rot(state.q)
    R = Rwc.transpose(-1, -2)
    t = -(R @ state.p[..., None])[..., 0]
    return R, t


class OdometryBuffer:
    """Planner-predicted odometry buffer (reference: BufferingOdom
    Tracking.cc:503, fed from the /desired_path topic in ros_stereo.cc:171,
    used to anticipate future poses for good-graph budgeting)."""

    def __init__(self, horizon: int = 256):
        self.horizon = horizon
        self._buf: list = []  # (timestamp, R, t)

    def push(self, timestamp: float, R: np.ndarray, t: np.ndarray):
        self._buf.append((timestamp, np.asarray(R), np.asarray(t)))
        if len(self._buf) > self.horizon:
            self._buf.pop(0)

    def predict_at(self, timestamp: float):
        """Nearest-in-time predicted pose, or None (reference: PredictingOdom
        Tracking.cc:515 / PredictRelMotionFromBuffer :1448)."""
        if not self._buf:
            return None
        ts = np.asarray([b[0] for b in self._buf])
        i = int(np.argmin(np.abs(ts - timestamp)))
        if abs(ts[i] - timestamp) > 0.5:
            return None
        return self._buf[i][1], self._buf[i][2]

    def relative_motion(self, t0: float, t1: float):
        """Predicted relative camera motion T(t1)·T(t0)⁻¹ as a 4x4, or None
        (reference: PredictRelMotionFromBuffer Tracking.cc:1448 — replaces
        the constant-velocity prediction when planner odometry is buffered).
        Buffered poses are world→cam."""
        a = self.predict_at(t0)
        b = self.predict_at(t1)
        if a is None or b is None:
            return None
        Ra, ta = a
        Rb, tb = b
        rel = np.eye(4, dtype=np.float32)
        rel[:3, :3] = Rb @ Ra.T
        rel[:3, 3] = tb - rel[:3, :3] @ ta
        return rel

    def clear(self):
        self._buf.clear()
