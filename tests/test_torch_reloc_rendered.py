"""Relocalization on the rendered circuit, on the port — `slow` (full-size
tracking on the CPU takes many minutes; chip_smoke.py's phase `reloc`
drives the same protocol on the card).

tests/test_reloc_rendered.py's protocol and gates: a 6-frame full blackout
(frames 70-75) mid-circuit, the camera reopening 16 frames back inside the
mapped territory; the tracker must go LOST, relocalize within 10 frames
without a reset, and the tail must track at normal accuracy.
"""
import numpy as np
import pytest
import torch

from gf_orb_slam2_tpu_torch import config as tconfig
from gf_orb_slam2_tpu_torch.io.evaluation import ate_rmse
from gf_orb_slam2_tpu_torch.system import System
from gf_orb_slam2_tpu_torch.tracking.tracker import TrackState
from tests.test_torch_loop_rendered import BASELINE, CX, CY, FX, FY, _circuit

torch.set_num_threads(1)

BLACKOUT = range(70, 76)
REWIND = 16
N_RUN = 110


@pytest.mark.slow
def test_blackout_lost_then_relocalize():
    poses, frames = _circuit()
    cam = tconfig.CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=FX * BASELINE, th_depth=40.0)
    cfg = tconfig.SystemConfig(
        sensor=tconfig.Sensor.STEREO, camera=cam, orb=tconfig.ORBConfig(n_features=800),
        capacity=tconfig.CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                        max_keyframes=160, max_local_points=2048),
        # loop closing on: the KF database is the candidate source
        loop=tconfig.LoopClosingConfig(enabled=True, synchronous_gba=True))
    slam = System(cfg, device="cpu")
    black = np.zeros((480, 640), np.float32)
    states, est, gt = [], {}, {}
    resets, kf_before = 0, 0
    for i in range(N_RUN):
        src = i if i < BLACKOUT[0] else max(i - REWIND, 0)
        R_cw, t_cw = poses[src]
        left, right = frames[src]
        if i in BLACKOUT:
            if i == BLACKOUT[0]:
                kf_before = slam.store.n_keyframes
            slam.track_stereo(black, black, i / 20.0)
        else:
            T = slam.track_stereo(left, right, i / 20.0)
            if slam.state == TrackState.OK:
                est[i] = -T[:3, :3].T @ T[:3, 3]
                gt[i] = -R_cw.T @ t_cw
        states.append(slam.state)
        if kf_before and slam.store.n_keyframes < kf_before:
            resets += 1
    slam.shutdown()
    assert TrackState.LOST in states[BLACKOUT[0]:BLACKOUT[-1] + 2], "blackout did not cause LOST"
    post = states[BLACKOUT[-1] + 1: BLACKOUT[-1] + 11]
    assert TrackState.OK in post, f"no relocalization: {post}"
    assert resets == 0, "system reset instead of relocalizing"
    assert slam.store.n_keyframes >= kf_before
    assert any(r.kf >= 0 for r in slam.tracker.reloc_stats)
    tail = [i for i in est if i > BLACKOUT[-1] + 4]
    assert len(tail) >= 25
    ate_tail = ate_rmse(np.stack([est[i] for i in tail]), np.stack([gt[i] for i in tail]))
    assert ate_tail < 0.25, f"post-reloc tail ATE {ate_tail:.3f} m"
