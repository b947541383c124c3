"""Trajectory writers: TUM and KITTI formats.

Reference: System::SaveTrajectoryTUM (src/System.cc:591),
SaveKeyFrameTrajectoryTUM (:651), SaveTrajectoryKITTI (:687). Full-frame
trajectories are recomposed as T_cw = T_rel · T_ref_kf using the per-frame
relative poses stored by the tracker (reference: Tracking.cc:1029-1053),
so post-hoc corrections to keyframes propagate to every frame.
"""
from __future__ import annotations

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.geometry import lie


def _pose_to_twc(T_cw: np.ndarray):
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    Rwc = R.T
    twc = -R.T @ t
    return Rwc, twc


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    return lie.rot_to_quat(torch.from_numpy(np.ascontiguousarray(R, np.float32))).numpy()


def recompose_trajectory(relative_poses, store):
    """[(frame_id, ts, T_rel, ref_kf, state)] → [(ts, T_cw)] using the
    CURRENT (possibly corrected) keyframe poses."""
    out = []
    for frame_id, ts, T_rel, ref_kf, state in relative_poses:
        if state != "OK":
            continue
        T_ref = np.eye(4, dtype=np.float32)
        T_ref[:3, :3] = store.kf_R[ref_kf]
        T_ref[:3, 3] = store.kf_t[ref_kf]
        out.append((ts, T_rel @ T_ref))
    return out


def tum_line(ts, T_cw) -> str:
    """One TUM trajectory line: timestamp, camera centre, quaternion x y z w."""
    Rwc, twc = _pose_to_twc(T_cw)
    q = _quat_wxyz(Rwc)  # [w,x,y,z]
    return (f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
            f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def save_trajectory_tum(path, relative_poses, store):
    with open(path, "w") as f:
        for ts, T_cw in recompose_trajectory(relative_poses, store):
            f.write(tum_line(ts, T_cw))


def save_keyframe_trajectory_tum(path, store):
    with open(path, "w") as f:
        for k in store.valid_kf_ids():
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = store.kf_R[k]
            T[:3, 3] = store.kf_t[k]
            f.write(tum_line(store.kf_timestamp[k], T))


def save_trajectory_kitti(path, relative_poses, store):
    with open(path, "w") as f:
        for ts, T_cw in recompose_trajectory(relative_poses, store):
            Rwc, twc = _pose_to_twc(T_cw)
            row = np.hstack([Rwc, twc[:, None]]).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")
